"""Version of the PyTorch port (``deepspeed_tpu_torch``); it tracks the JAX
package's capability set of the same version."""

__version__ = "0.1.0"
