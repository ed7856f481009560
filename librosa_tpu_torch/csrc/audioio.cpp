// Audio decoding on the host for librosa_tpu_torch: what ``load`` and
// ``stream`` read before the samples go to the card.
//
// Built with g++ (not nvcc) into a plain shared library with a C interface,
// loaded with ctypes (``librosa_tpu_torch/io/_native.py``). It holds:
//   - a WAV (RIFF) parser: PCM 8/16/24/32, float32/64, extensible
//   - a FLAC decoder written from the FLAC format specification
//   - Ogg Vorbis through the system's libvorbisfile (dlopen'd on first use)
//   - MP3 through the system's libmpg123 (dlopen'd on first use)
// Neither codec library is linked: a system without them decodes WAV and
// FLAC all the same.
//
// The core abstraction is a STREAMING handle: open once, seek to a frame,
// read N frames at a time with O(block) memory (WAV reads straight off the
// file; FLAC decodes through a fixed sliding window; ogg/mp3 use the
// libraries' own pull APIs).  The one-shot decode entry point is just a
// stream that reads to EOF, so every decode exercises the streaming core.
//
// C ABI:
//   void* lt_open(path)                      // NULL on failure
//   int   lt_stream_sr(h), lt_stream_channels(h)
//   long  lt_stream_frames(h)                // total frames, -1 if unknown
//   long  lt_stream_read(h, float* out, long max_frames)  // 0 at EOF, <0 err
//   int   lt_stream_seek(h, long frame)      // absolute frame position
//   void  lt_stream_close(h)
//   int lt_decode(path, &data, &frames, &channels, &sr)  // one-shot, malloc'd
//   int lt_info(path, &sr, &channels, &frames)           // header-only probe
//   void lt_free(ptr)
//   const char* lt_last_error()
//
// Returns 0 on success, negative on failure (stream reads: frames, or <0).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <string>
#include <vector>

static thread_local std::string g_error;

static void set_error(const std::string &msg) { g_error = msg; }

extern "C" const char *lt_last_error() { return g_error.c_str(); }
extern "C" void lt_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// Helpers
// ---------------------------------------------------------------------------

static inline uint32_t rd_u32le(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static inline uint16_t rd_u16le(const uint8_t *p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}

// Convert interleaved PCM bytes to float32 in [-1, 1).
static bool pcm_to_float(const uint8_t *data, float *o, size_t n_samp,
                         uint16_t fmt, int bits) {
  if (fmt == 1) { // integer PCM
    switch (bits) {
    case 16:
      for (size_t i = 0; i < n_samp; i++)
        o[i] = (float)(int16_t)rd_u16le(data + 2 * i) / 32768.0f;
      return true;
    case 24:
      for (size_t i = 0; i < n_samp; i++) {
        const uint8_t *p = data + 3 * i;
        int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
        if (v & 0x800000) v -= 0x1000000;
        o[i] = (float)v / 8388608.0f;
      }
      return true;
    case 32:
      for (size_t i = 0; i < n_samp; i++)
        o[i] = (float)((double)(int32_t)rd_u32le(data + 4 * i) / 2147483648.0);
      return true;
    case 8:
      for (size_t i = 0; i < n_samp; i++)
        o[i] = ((float)data[i] - 128.0f) / 128.0f;
      return true;
    }
    set_error("unsupported WAV PCM depth");
    return false;
  }
  if (fmt == 3) { // IEEE float
    if (bits == 32) {
      memcpy(o, data, n_samp * 4);
      return true;
    }
    if (bits == 64) {
      for (size_t i = 0; i < n_samp; i++) {
        double d;
        memcpy(&d, data + 8 * i, 8);
        o[i] = (float)d;
      }
      return true;
    }
    set_error("unsupported WAV float depth");
    return false;
  }
  set_error("unsupported WAV format tag");
  return false;
}

// ---------------------------------------------------------------------------
// FLAC bit reader — frame-level decode against the FLAC format specification
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t *data;
  size_t size;
  size_t byte = 0;
  int bit = 0; // 0..7, MSB-first
  bool ok = true;

  BitReader(const uint8_t *d, size_t n) : data(d), size(n) {}

  inline uint32_t read_bit() {
    if (byte >= size) {
      ok = false;
      return 0;
    }
    uint32_t v = (data[byte] >> (7 - bit)) & 1;
    if (++bit == 8) {
      bit = 0;
      byte++;
    }
    return v;
  }

  inline uint64_t read_bits(int n) {
    uint64_t v = 0;
    // fast path: byte-aligned whole bytes
    while (n >= 8 && bit == 0 && byte < size) {
      v = (v << 8) | data[byte++];
      n -= 8;
    }
    while (n > 0) {
      v = (v << 1) | read_bit();
      n--;
    }
    return v;
  }

  inline int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n > 0 && (v >> (n - 1)) & 1) return (int64_t)(v | (~0ULL << n));
    return (int64_t)v;
  }

  inline uint32_t read_unary() {
    uint32_t q = 0;
    while (ok && read_bit() == 0) q++;
    return q;
  }

  inline void align() {
    if (bit) {
      bit = 0;
      byte++;
    }
  }
};

static const int64_t *fixed_coefs(int order, int &n) {
  static const int64_t c1[] = {1};
  static const int64_t c2[] = {2, -1};
  static const int64_t c3[] = {3, -3, 1};
  static const int64_t c4[] = {4, -6, 4, -1};
  switch (order) {
  case 1: n = 1; return c1;
  case 2: n = 2; return c2;
  case 3: n = 3; return c3;
  case 4: n = 4; return c4;
  default: n = 0; return nullptr;
  }
}

static bool flac_residual(BitReader &br, int blocksize, int pred_order,
                          std::vector<int64_t> &out) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) {
    set_error("FLAC: bad residual method");
    return false;
  }
  int pbits = method == 0 ? 4 : 5;
  uint32_t esc = method == 0 ? 15 : 31;
  uint32_t porder = (uint32_t)br.read_bits(4);
  uint32_t partitions = 1u << porder;
  if (blocksize % partitions) {
    set_error("FLAC: partition mismatch");
    return false;
  }
  int idx = pred_order;
  for (uint32_t p = 0; p < partitions; p++) {
    int count = blocksize >> porder;
    if (p == 0) count -= pred_order;
    uint32_t param = (uint32_t)br.read_bits(pbits);
    if (param == esc) {
      int nbits = (int)br.read_bits(5);
      for (int i = 0; i < count; i++) out[idx++] = br.read_signed(nbits);
    } else {
      for (int i = 0; i < count; i++) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits(param);
        uint64_t v = ((uint64_t)q << param) | r;
        out[idx++] = (int64_t)((v >> 1) ^ -(int64_t)(v & 1));
      }
    }
    if (!br.ok) return false; // window exhausted — caller refills and retries
  }
  return true;
}

static bool flac_subframe(BitReader &br, int blocksize, int bps,
                          std::vector<int64_t> &out) {
  if (br.read_bit() != 0) {
    set_error("FLAC: bad subframe padding bit");
    return false;
  }
  uint32_t type = (uint32_t)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) {
    wasted = 1 + (int)br.read_unary();
    bps -= wasted;
  }
  out.assign(blocksize, 0);

  if (type == 0) { // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; i++) out[i] = v;
  } else if (type == 1) { // VERBATIM
    for (int i = 0; i < blocksize; i++) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) { // FIXED, order = type - 8
    int order = (int)type - 8;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    if (!flac_residual(br, blocksize, order, out)) return false;
    int nc;
    const int64_t *c = fixed_coefs(order, nc);
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < nc; j++) pred += c[j] * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type >= 32) { // LPC, order = type - 31
    int order = (int)type - 31;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) {
      set_error("FLAC: invalid qlp precision");
      return false;
    }
    int shift = (int)br.read_signed(5);
    if (shift < 0) shift = 0;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(precision);
    if (!flac_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    set_error("FLAC: reserved subframe type");
    return false;
  }
  if (wasted)
    for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
  return br.ok;
}

// ---------------------------------------------------------------------------
// dlopen'd library APIs (vorbisfile / mpg123) — declared from public headers
// ---------------------------------------------------------------------------

struct lt_vorbis_info {
  int version;
  int channels;
  long rate;
  long bitrate_upper, bitrate_nominal, bitrate_lower, bitrate_window;
  void *codec_setup;
};

struct VorbisApi {
  int (*fopen_)(const char *, void *) = nullptr;
  lt_vorbis_info *(*info)(void *, int) = nullptr;
  int64_t (*pcm_total)(void *, int) = nullptr;
  long (*read_float)(void *, float ***, int, int *) = nullptr;
  int (*pcm_seek)(void *, int64_t) = nullptr;
  int (*clear)(void *) = nullptr;
  bool usable() const { return fopen_ && info && pcm_total && read_float && clear; }
};

static const VorbisApi *vorbis_api() {
  static VorbisApi api;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void *lib = dlopen("libvorbisfile.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) lib = dlopen("libvorbisfile.so", RTLD_NOW | RTLD_GLOBAL);
    if (lib) {
      api.fopen_ = (int (*)(const char *, void *))dlsym(lib, "ov_fopen");
      api.info = (lt_vorbis_info * (*)(void *, int)) dlsym(lib, "ov_info");
      api.pcm_total = (int64_t(*)(void *, int))dlsym(lib, "ov_pcm_total");
      api.read_float =
          (long (*)(void *, float ***, int, int *))dlsym(lib, "ov_read_float");
      api.pcm_seek = (int (*)(void *, int64_t))dlsym(lib, "ov_pcm_seek");
      api.clear = (int (*)(void *))dlsym(lib, "ov_clear");
    }
  }
  return api.usable() ? &api : nullptr;
}

struct Mp3Api {
  int (*init)(void) = nullptr;
  void *(*new_)(const char *, int *) = nullptr;
  int (*open)(void *, const char *) = nullptr;
  int (*getformat)(void *, long *, int *, int *) = nullptr;
  int (*format_none)(void *) = nullptr;
  int (*format)(void *, long, int, int) = nullptr;
  int (*read)(void *, void *, size_t, size_t *) = nullptr;
  int (*scan)(void *) = nullptr;
  long (*length)(void *) = nullptr;
  long (*seek)(void *, long, int) = nullptr;
  int (*close)(void *) = nullptr;
  void (*del)(void *) = nullptr;
  bool usable() const { return init && new_ && open && getformat && read; }
};

static const Mp3Api *mp3_api() {
  static Mp3Api api;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void *lib = dlopen("libmpg123.so.0", RTLD_NOW);
    if (!lib) lib = dlopen("libmpg123.so", RTLD_NOW);
    if (lib) {
      api.init = (int (*)(void))dlsym(lib, "mpg123_init");
      api.new_ = (void *(*)(const char *, int *))dlsym(lib, "mpg123_new");
      api.open = (int (*)(void *, const char *))dlsym(lib, "mpg123_open");
      api.getformat =
          (int (*)(void *, long *, int *, int *))dlsym(lib, "mpg123_getformat");
      api.format_none = (int (*)(void *))dlsym(lib, "mpg123_format_none");
      api.format = (int (*)(void *, long, int, int))dlsym(lib, "mpg123_format");
      api.read = (int (*)(void *, void *, size_t, size_t *))dlsym(lib, "mpg123_read");
      api.scan = (int (*)(void *))dlsym(lib, "mpg123_scan");
      api.length = (long (*)(void *))dlsym(lib, "mpg123_length");
      api.seek = (long (*)(void *, long, int))dlsym(lib, "mpg123_seek");
      api.close = (int (*)(void *))dlsym(lib, "mpg123_close");
      api.del = (void (*)(void *))dlsym(lib, "mpg123_delete");
      if (api.init) api.init();
    }
  }
  return api.usable() ? &api : nullptr;
}

// ---------------------------------------------------------------------------
// Streaming handle
// ---------------------------------------------------------------------------

enum LtKind { LT_WAV = 1, LT_FLAC, LT_VORBIS, LT_MP3 };

// FLAC sliding-window size: comfortably above the worst-case frame
// (max blocksize 65535 × 8 ch × 33 bits ≈ 2.1 MB is pathological; real
// encoders stay far below 1 MB) while keeping memory O(1) in file size.
static const size_t FLAC_WIN = 4u << 20;

struct LtStream {
  int kind = 0;
  int sr = 0, channels = 0;
  long total_frames = -1; // -1 = unknown
  long pos = 0;           // next frame index to be returned

  // WAV
  FILE *wf = nullptr;
  long wav_data_off = 0;
  uint16_t wav_fmt = 0;
  int wav_bits = 0;
  std::vector<uint8_t> wav_raw; // per-read staging

  // FLAC
  FILE *ff = nullptr;
  long flac_audio_off = 0; // file offset of the first frame
  int flac_bps = 0;
  std::vector<uint8_t> win;
  size_t win_valid = 0;
  size_t rd_byte = 0; // reader position within win (frames are byte-aligned)
  bool file_eof = false;
  std::vector<std::vector<int64_t>> chan;
  std::vector<float> pending; // decoded interleaved samples not yet returned
  size_t pending_off = 0;     // consumed floats at the front of pending
  long decoded_upto = 0;      // frames decoded from the file so far

  // Vorbis
  std::vector<uint8_t> vf;
  bool v_open = false;

  // MP3
  void *mh = nullptr;

  ~LtStream() {
    if (wf) fclose(wf);
    if (ff) fclose(ff);
    if (v_open) {
      const VorbisApi *v = vorbis_api();
      if (v) v->clear(vf.data());
    }
    if (mh) {
      const Mp3Api *m = mp3_api();
      if (m) {
        if (m->close) m->close(mh);
        if (m->del) m->del(mh);
      }
    }
  }
};

// ---- WAV ----

static bool wav_open(LtStream *s, const char *path) {
  s->wf = fopen(path, "rb");
  if (!s->wf) {
    set_error(std::string("cannot open file: ") + path);
    return false;
  }
  uint8_t hdr12[12];
  if (fread(hdr12, 1, 12, s->wf) != 12 || memcmp(hdr12, "RIFF", 4) ||
      memcmp(hdr12 + 8, "WAVE", 4)) {
    set_error("not a RIFF/WAVE file");
    return false;
  }
  fseek(s->wf, 0, SEEK_END);
  long file_size = ftell(s->wf);
  fseek(s->wf, 12, SEEK_SET);

  long data_len = 0;
  uint16_t nch = 0;
  uint32_t rate = 0;
  uint8_t ch_hdr[8];
  while (fread(ch_hdr, 1, 8, s->wf) == 8) {
    uint32_t clen = rd_u32le(ch_hdr + 4);
    long body = ftell(s->wf);
    if (!memcmp(ch_hdr, "fmt ", 4) && clen >= 16) {
      std::vector<uint8_t> fmtbuf(clen < 64 ? clen : 64);
      if (fread(fmtbuf.data(), 1, fmtbuf.size(), s->wf) != fmtbuf.size())
        break;
      s->wav_fmt = rd_u16le(fmtbuf.data());
      nch = rd_u16le(fmtbuf.data() + 2);
      rate = rd_u32le(fmtbuf.data() + 4);
      s->wav_bits = rd_u16le(fmtbuf.data() + 14);
      if (s->wav_fmt == 0xFFFE && clen >= 40)
        s->wav_fmt = rd_u16le(fmtbuf.data() + 24); // extensible subformat
    } else if (!memcmp(ch_hdr, "data", 4)) {
      s->wav_data_off = body;
      data_len = (long)clen;
      if (body + data_len > file_size) data_len = file_size - body;
    }
    long next = body + (long)clen + (long)(clen & 1);
    if (fseek(s->wf, next, SEEK_SET) != 0) break;
  }
  if (!s->wav_data_off || !nch || !rate) {
    set_error("WAV missing fmt/data chunk");
    return false;
  }
  int bytes_per = s->wav_bits / 8;
  if (!bytes_per) {
    set_error("bad WAV bit depth");
    return false;
  }
  s->sr = (int)rate;
  s->channels = nch;
  s->total_frames = data_len / ((long)bytes_per * nch);
  return true;
}

static long wav_read(LtStream *s, float *out, long max_frames) {
  long remain = s->total_frames - s->pos;
  if (remain <= 0) return 0;
  long n = max_frames < remain ? max_frames : remain;
  int bytes_per = s->wav_bits / 8;
  long stride = (long)bytes_per * s->channels;
  if (fseek(s->wf, s->wav_data_off + s->pos * stride, SEEK_SET) != 0) {
    set_error("WAV seek failed");
    return -1;
  }
  s->wav_raw.resize((size_t)(n * stride));
  size_t got = fread(s->wav_raw.data(), 1, (size_t)(n * stride), s->wf);
  long got_frames = (long)(got / (size_t)stride);
  if (got_frames <= 0) return 0;
  if (!pcm_to_float(s->wav_raw.data(), out,
                    (size_t)got_frames * (size_t)s->channels, s->wav_fmt,
                    s->wav_bits))
    return -1;
  s->pos += got_frames;
  return got_frames;
}

// ---- FLAC ----

static bool flac_refill(LtStream *s) {
  if (s->rd_byte > 0) {
    size_t keep = s->win_valid - s->rd_byte;
    memmove(s->win.data(), s->win.data() + s->rd_byte, keep);
    s->win_valid = keep;
    s->rd_byte = 0;
  }
  if (s->win.size() < FLAC_WIN) s->win.resize(FLAC_WIN);
  if (s->win_valid == s->win.size())
    s->win.resize(s->win.size() * 2); // pathological frame > window: grow
  size_t got =
      fread(s->win.data() + s->win_valid, 1, s->win.size() - s->win_valid, s->ff);
  s->win_valid += got;
  if (got == 0) s->file_eof = true;
  return got > 0;
}

static bool flac_open(LtStream *s, const char *path) {
  s->ff = fopen(path, "rb");
  if (!s->ff) {
    set_error(std::string("cannot open file: ") + path);
    return false;
  }
  uint8_t magic[4];
  if (fread(magic, 1, 4, s->ff) != 4 || memcmp(magic, "fLaC", 4)) {
    set_error("not a FLAC file");
    return false;
  }
  // metadata blocks
  bool last = false;
  uint64_t total = 0;
  while (!last) {
    uint8_t bh[4];
    if (fread(bh, 1, 4, s->ff) != 4) {
      set_error("FLAC: truncated metadata");
      return false;
    }
    last = bh[0] & 0x80;
    int btype = bh[0] & 0x7F;
    uint32_t blen = ((uint32_t)bh[1] << 16) | ((uint32_t)bh[2] << 8) | bh[3];
    if (btype == 0 && blen >= 34) { // STREAMINFO
      std::vector<uint8_t> body(blen);
      if (fread(body.data(), 1, blen, s->ff) != blen) {
        set_error("FLAC: truncated STREAMINFO");
        return false;
      }
      s->sr = ((int)body[10] << 12) | ((int)body[11] << 4) | (body[12] >> 4);
      s->channels = ((body[12] >> 1) & 0x7) + 1;
      s->flac_bps = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1;
      total = ((uint64_t)(body[13] & 0xF) << 32) | ((uint64_t)body[14] << 24) |
              ((uint64_t)body[15] << 16) | ((uint64_t)body[16] << 8) | body[17];
    } else {
      if (fseek(s->ff, (long)blen, SEEK_CUR) != 0) {
        set_error("FLAC: metadata seek failed");
        return false;
      }
    }
  }
  if (!s->sr || !s->channels) {
    set_error("FLAC: missing STREAMINFO");
    return false;
  }
  s->total_frames = total ? (long)total : -1;
  s->flac_audio_off = ftell(s->ff);
  s->chan.assign((size_t)s->channels, {});
  s->win.reserve(FLAC_WIN);
  return true;
}

// Decode ONE FLAC frame from the window into s->pending.
// Returns 1 on success, 0 = need more data (refill and retry),
// 2 = clean EOF, -1 = bitstream error.
static int flac_decode_frame(LtStream *s) {
  if (s->total_frames > 0 && s->decoded_upto >= s->total_frames)
    return 2; // all declared samples decoded; ignore trailing bytes
  if (s->rd_byte + 2 > s->win_valid) return s->file_eof ? 2 : 0;

  BitReader br(s->win.data(), s->win_valid);
  br.byte = s->rd_byte;

  uint32_t sync = (uint32_t)br.read_bits(14);
  if (!br.ok) return s->file_eof ? 2 : 0;
  if (sync != 0x3FFE) {
    set_error("FLAC: lost frame sync");
    return -1;
  }
  br.read_bit(); // reserved
  br.read_bit(); // blocking strategy
  uint32_t bs_code = (uint32_t)br.read_bits(4);
  uint32_t sr_code = (uint32_t)br.read_bits(4);
  uint32_t ch_code = (uint32_t)br.read_bits(4);
  uint32_t ss_code = (uint32_t)br.read_bits(3);
  br.read_bit(); // reserved

  // UTF-8 coded frame/sample number: skip
  uint32_t first = (uint32_t)br.read_bits(8);
  int follow = 0;
  for (uint32_t m = 0x80; first & m; m >>= 1) follow++;
  if (follow) follow--; // leading-1 count minus 1 = continuation bytes
  for (int i = 0; i < follow; i++) br.read_bits(8);

  int blocksize;
  switch (bs_code) {
  case 1: blocksize = 192; break;
  case 2: case 3: case 4: case 5:
    blocksize = 576 << (bs_code - 2); break;
  case 6: blocksize = (int)br.read_bits(8) + 1; break;
  case 7: blocksize = (int)br.read_bits(16) + 1; break;
  default:
    if (bs_code >= 8) blocksize = 256 << (bs_code - 8);
    else { set_error("FLAC: reserved blocksize"); return -1; }
  }
  if (sr_code == 12) br.read_bits(8);
  else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

  int n_ch;
  int stereo_mode = 0; // 0=independent, 1=L/S, 2=R/S, 3=M/S
  if (ch_code < 8) n_ch = (int)ch_code + 1;
  else if (ch_code == 8) { n_ch = 2; stereo_mode = 1; }
  else if (ch_code == 9) { n_ch = 2; stereo_mode = 2; }
  else if (ch_code == 10) { n_ch = 2; stereo_mode = 3; }
  else { set_error("FLAC: reserved channel assignment"); return -1; }
  if (n_ch != s->channels) {
    set_error("FLAC: channel count change unsupported");
    return -1;
  }

  int bps;
  switch (ss_code) {
  case 0: bps = s->flac_bps; break;
  case 1: bps = 8; break;
  case 2: bps = 12; break;
  case 4: bps = 16; break;
  case 5: bps = 20; break;
  case 6: bps = 24; break;
  case 7: bps = 32; break;
  default: set_error("FLAC: reserved sample size"); return -1;
  }
  br.read_bits(8); // CRC-8 (unchecked)
  if (!br.ok) return s->file_eof ? -1 : 0;

  for (int c = 0; c < n_ch; c++) {
    int sub_bps = bps;
    if ((stereo_mode == 1 && c == 1) || (stereo_mode == 2 && c == 0) ||
        (stereo_mode == 3 && c == 1))
      sub_bps += 1; // side channel carries one extra bit
    if (!flac_subframe(br, blocksize, sub_bps, s->chan[(size_t)c])) {
      if (!br.ok && !s->file_eof) return 0; // retry after refill
      if (!br.ok) set_error("FLAC: bitstream exhausted in frame");
      return -1;
    }
  }
  br.align();
  br.read_bits(16); // CRC-16 (unchecked)
  if (!br.ok) return s->file_eof ? -1 : 0;

  // Undo stereo decorrelation
  auto &chan = s->chan;
  if (stereo_mode == 1) { // left/side → right = left - side
    for (int i = 0; i < blocksize; i++) chan[1][i] = chan[0][i] - chan[1][i];
  } else if (stereo_mode == 2) { // right/side → left = side + right
    for (int i = 0; i < blocksize; i++) chan[0][i] = chan[0][i] + chan[1][i];
  } else if (stereo_mode == 3) { // mid/side
    for (int i = 0; i < blocksize; i++) {
      int64_t side = chan[1][i];
      int64_t mid = (chan[0][i] << 1) | (side & 1);
      chan[0][i] = (mid + side) >> 1;
      chan[1][i] = (mid - side) >> 1;
    }
  }

  float scale = 1.0f / (float)(1LL << (bps - 1));
  size_t base = s->pending.size();
  s->pending.resize(base + (size_t)blocksize * (size_t)n_ch);
  for (int i = 0; i < blocksize; i++)
    for (int c = 0; c < n_ch; c++)
      s->pending[base + (size_t)i * n_ch + c] =
          (float)chan[(size_t)c][i] * scale;

  s->rd_byte = br.byte;
  s->decoded_upto += blocksize;
  return 1;
}

// Ensure at least one frame of decoded samples is pending (or EOF).
// Returns 1 if pending has data, 0 at EOF, -1 on error.
static int flac_fill_pending(LtStream *s) {
  while (s->pending.size() == s->pending_off) {
    size_t save = s->rd_byte;
    int rc = flac_decode_frame(s);
    if (rc == 1) continue;
    if (rc == 2) return 0;
    if (rc == 0) {
      s->rd_byte = save;
      if (!flac_refill(s) && s->file_eof) {
        // retry once against EOF so the final frame decodes
        int rc2 = flac_decode_frame(s);
        if (rc2 == 1) continue;
        return rc2 == 2 ? 0 : -1;
      }
      continue;
    }
    return -1;
  }
  return 1;
}

static long flac_read(LtStream *s, float *out, long max_frames) {
  long written = 0;
  int ch = s->channels;
  while (written < max_frames) {
    size_t avail = (s->pending.size() - s->pending_off) / (size_t)ch;
    if (avail == 0) {
      // compact consumed samples before decoding more
      if (s->pending_off) {
        s->pending.erase(s->pending.begin(),
                         s->pending.begin() + (long)s->pending_off);
        s->pending_off = 0;
      }
      int rc = flac_fill_pending(s);
      if (rc < 0) return -1;
      if (rc == 0) break;
      continue;
    }
    long take = (long)avail < max_frames - written ? (long)avail
                                                   : max_frames - written;
    memcpy(out + (size_t)written * ch, s->pending.data() + s->pending_off,
           (size_t)take * ch * sizeof(float));
    s->pending_off += (size_t)take * ch;
    written += take;
  }
  s->pos += written;
  return written;
}

static int flac_seek(LtStream *s, long frame) {
  // pending holds frames [decoded_upto − pending_frames, decoded_upto)
  long pending_frames =
      (long)((s->pending.size() - s->pending_off) / s->channels);
  long pending_begin = s->decoded_upto - pending_frames;

  if (frame < pending_begin) {
    // behind the buffered region: rewind to the first audio frame
    if (fseek(s->ff, s->flac_audio_off, SEEK_SET) != 0) {
      set_error("FLAC: seek failed");
      return -1;
    }
    s->win_valid = 0;
    s->rd_byte = 0;
    s->file_eof = false;
    s->pending.clear();
    s->pending_off = 0;
    s->decoded_upto = 0;
    s->pos = 0;
  }
  // decode-and-discard forward until pending covers the target (or EOF);
  // everything buffered inside this loop lies strictly before `frame`
  while (s->decoded_upto < frame) {
    s->pending.clear();
    s->pending_off = 0;
    int rc = flac_fill_pending(s);
    if (rc < 0) return -1;
    if (rc == 0) break; // EOF before target: position at end
  }
  pending_frames = (long)((s->pending.size() - s->pending_off) / s->channels);
  pending_begin = s->decoded_upto - pending_frames;
  long skip = frame - pending_begin;
  if (skip < 0) skip = 0;
  if (skip > pending_frames) skip = pending_frames;
  s->pending_off += (size_t)skip * s->channels;
  s->pos = pending_begin + skip;
  return 0;
}

// ---- Vorbis ----

static bool vorbis_open(LtStream *s, const char *path) {
  const VorbisApi *v = vorbis_api();
  if (!v) {
    set_error("libvorbisfile not available");
    return false;
  }
  s->vf.assign(2048, 0); // OggVorbis_File is ~944 bytes; allocate generously
  if (v->fopen_(path, s->vf.data()) != 0) {
    set_error("ov_fopen failed (not a vorbis stream?)");
    return false;
  }
  s->v_open = true;
  lt_vorbis_info *vi = v->info(s->vf.data(), -1);
  if (!vi) {
    set_error("ov_info failed");
    return false;
  }
  s->channels = vi->channels;
  s->sr = (int)vi->rate;
  int64_t total = v->pcm_total(s->vf.data(), -1);
  s->total_frames = total > 0 ? (long)total : -1;
  return true;
}

static long vorbis_read(LtStream *s, float *out, long max_frames) {
  const VorbisApi *v = vorbis_api();
  int bitstream = 0;
  long written = 0;
  while (written < max_frames) {
    float **ch_data = nullptr;
    int want = (int)(max_frames - written);
    if (want > 4096) want = 4096;
    long got = v->read_float(s->vf.data(), &ch_data, want, &bitstream);
    if (got <= 0) break;
    for (long i = 0; i < got; i++)
      for (int c = 0; c < s->channels; c++)
        out[(size_t)(written + i) * s->channels + c] = ch_data[c][i];
    written += got;
  }
  s->pos += written;
  return written;
}

static int vorbis_seek(LtStream *s, long frame) {
  const VorbisApi *v = vorbis_api();
  if (!v->pcm_seek) {
    set_error("ov_pcm_seek not available");
    return -1;
  }
  if (v->pcm_seek(s->vf.data(), (int64_t)frame) != 0) {
    set_error("ov_pcm_seek failed");
    return -1;
  }
  s->pos = frame;
  return 0;
}

// ---- MP3 ----

static bool mp3_open(LtStream *s, const char *path) {
  const Mp3Api *m = mp3_api();
  if (!m) {
    set_error("libmpg123 not available");
    return false;
  }
  int err = 0;
  s->mh = m->new_(nullptr, &err);
  if (!s->mh) {
    set_error("mpg123_new failed");
    return false;
  }
  if (m->open(s->mh, path) != 0) {
    set_error("mpg123_open failed");
    return false;
  }
  long rate = 0;
  int nch = 0, enc = 0;
  m->getformat(s->mh, &rate, &nch, &enc);
  const int MPG123_ENC_FLOAT_32 = 0x200;
  if (m->format_none && m->format) {
    m->format_none(s->mh);
    m->format(s->mh, rate, nch, MPG123_ENC_FLOAT_32);
  }
  s->sr = (int)rate;
  s->channels = nch;
  if (m->scan && m->length) {
    m->scan(s->mh);
    long len = m->length(s->mh);
    s->total_frames = len > 0 ? len : -1;
  }
  return true;
}

static long mp3_read(LtStream *s, float *out, long max_frames) {
  const Mp3Api *m = mp3_api();
  size_t want_bytes = (size_t)max_frames * s->channels * sizeof(float);
  size_t got_bytes = 0;
  while (got_bytes < want_bytes) {
    size_t done = 0;
    int r = m->read(s->mh, (uint8_t *)out + got_bytes, want_bytes - got_bytes,
                    &done);
    got_bytes += done;
    if (r != 0 && done == 0) break; // MPG123_DONE or error
  }
  long frames = (long)(got_bytes / (s->channels * sizeof(float)));
  s->pos += frames;
  return frames;
}

static int mp3_seek(LtStream *s, long frame) {
  const Mp3Api *m = mp3_api();
  if (!m->seek) {
    set_error("mpg123_seek not available");
    return -1;
  }
  long got = m->seek(s->mh, frame, 0 /* SEEK_SET */);
  if (got < 0) {
    set_error("mpg123_seek failed");
    return -1;
  }
  s->pos = got;
  return 0;
}

// ---------------------------------------------------------------------------
// Public streaming ABI
// ---------------------------------------------------------------------------

extern "C" void *lt_open(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open file: ") + path);
    return nullptr;
  }
  uint8_t magic[4] = {0};
  size_t got = fread(magic, 1, 4, f);
  fclose(f);
  if (got < 4) {
    set_error("file too small");
    return nullptr;
  }

  LtStream *s = new LtStream();
  bool ok = false;
  if (!memcmp(magic, "RIFF", 4)) {
    s->kind = LT_WAV;
    ok = wav_open(s, path);
  } else if (!memcmp(magic, "fLaC", 4)) {
    s->kind = LT_FLAC;
    ok = flac_open(s, path);
  } else if (!memcmp(magic, "OggS", 4)) {
    s->kind = LT_VORBIS;
    ok = vorbis_open(s, path);
  } else if (!memcmp(magic, "ID3", 3) ||
             (magic[0] == 0xFF && (magic[1] & 0xE0) == 0xE0)) {
    s->kind = LT_MP3;
    ok = mp3_open(s, path);
  } else {
    set_error("unrecognized audio format");
  }
  if (!ok) {
    delete s;
    return nullptr;
  }
  return s;
}

extern "C" int lt_stream_sr(void *h) { return ((LtStream *)h)->sr; }
extern "C" int lt_stream_channels(void *h) { return ((LtStream *)h)->channels; }
extern "C" long lt_stream_frames(void *h) { return ((LtStream *)h)->total_frames; }

extern "C" long lt_stream_read(void *h, float *out, long max_frames) {
  LtStream *s = (LtStream *)h;
  if (max_frames <= 0) return 0;
  switch (s->kind) {
  case LT_WAV: return wav_read(s, out, max_frames);
  case LT_FLAC: return flac_read(s, out, max_frames);
  case LT_VORBIS: return vorbis_read(s, out, max_frames);
  case LT_MP3: return mp3_read(s, out, max_frames);
  }
  set_error("bad stream handle");
  return -1;
}

extern "C" int lt_stream_seek(void *h, long frame) {
  LtStream *s = (LtStream *)h;
  if (frame < 0) frame = 0;
  switch (s->kind) {
  case LT_WAV:
    if (s->total_frames >= 0 && frame > s->total_frames)
      frame = s->total_frames;
    s->pos = frame;
    return 0;
  case LT_FLAC: return flac_seek(s, frame);
  case LT_VORBIS: return vorbis_seek(s, frame);
  case LT_MP3: return mp3_seek(s, frame);
  }
  set_error("bad stream handle");
  return -1;
}

extern "C" void lt_stream_close(void *h) { delete (LtStream *)h; }

// ---------------------------------------------------------------------------
// One-shot decode / probe — consumers of the streaming core
// ---------------------------------------------------------------------------

extern "C" int lt_decode(const char *path, float **out, long *frames,
                         int *channels, int *sr) {
  LtStream *s = (LtStream *)lt_open(path);
  if (!s) return -1;
  *channels = s->channels;
  *sr = s->sr;

  const long CHUNK = 1 << 16;
  std::vector<float> pcm;
  if (s->total_frames > 0)
    pcm.reserve((size_t)s->total_frames * (size_t)s->channels);
  std::vector<float> buf((size_t)CHUNK * (size_t)s->channels);
  long total = 0;
  for (;;) {
    long got = lt_stream_read(s, buf.data(), CHUNK);
    if (got < 0) {
      lt_stream_close(s);
      return -1;
    }
    if (got == 0) break;
    pcm.insert(pcm.end(), buf.begin(), buf.begin() + (size_t)got * s->channels);
    total += got;
  }
  lt_stream_close(s);

  float *o = (float *)malloc(pcm.size() * sizeof(float));
  if (!o) {
    set_error("oom");
    return -2;
  }
  memcpy(o, pcm.data(), pcm.size() * sizeof(float));
  *out = o;
  *frames = total;
  return 0;
}

extern "C" int lt_info(const char *path, int *sr, int *channels, long *frames) {
  LtStream *s = (LtStream *)lt_open(path);
  if (!s) return -1;
  *sr = s->sr;
  *channels = s->channels;
  long total = s->total_frames;
  if (total < 0) {
    // unknown from headers (rare): count by decoding
    const long CHUNK = 1 << 16;
    std::vector<float> buf((size_t)CHUNK * (size_t)s->channels);
    total = 0;
    for (;;) {
      long got = lt_stream_read(s, buf.data(), CHUNK);
      if (got <= 0) break;
      total += got;
    }
  }
  *frames = total;
  lt_stream_close(s);
  return 0;
}
