"""uwspr_tpu — weak-signal WSPR decode framework for the GPU (JAX/XLA).

A from-scratch JAX/XLA re-design of the capabilities of the GNU Radio
reference ``michelbarbeau/gr-uwspr`` (see SURVEY.md): 375 S/s 4-FSK WSPR
frames for underwater acoustic channels, decoded by a batched, array-oriented
pipeline — STFT coarse search, dense matched-filter sync/demodulation,
batched Fano sequential decoding — that shards receive channels and time
blocks over a device mesh.
"""

__version__ = "0.1.0"
