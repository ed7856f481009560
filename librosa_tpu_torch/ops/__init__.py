"""Device operations: framing, FFT, transforms and the fused STFT-basis kernel."""
