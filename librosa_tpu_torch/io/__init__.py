"""Host-side bindings: libsoxr for the ``soxr_*`` resampling qualities."""
