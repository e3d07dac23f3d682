"""PyTorch and CUDA port of the LDPC moment-encoded robust gradient descent
system.  It mirrors the JAX package's module paths: the counterpart of
``repro/core/decoder.py`` is ``repro_torch/core/decoder.py``.  It imports
neither JAX nor the JAX package."""
