"""Core DSP helpers of the port (counterpart of ``qampy_tpu/core``)."""
