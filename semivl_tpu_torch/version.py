"""The port's version, written into run configs and run names as the JAX
package writes its own (``semivl_tpu/version.py``)."""

__version__ = "0.1.0"
