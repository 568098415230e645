"""Worker-pool environment shielding — the port of
fast_nnunet_tpu/utils/mp_env.py.

Host worker processes (fingerprinting, preprocessing) must not claim the
card: each process that made a CUDA context would pin about 500 MB of device
memory for nothing. Around the creation of a spawned pool the parent hides
the card (``CUDA_VISIBLE_DEVICES=""``; the children inherit the cleaned
environment), keeps ``JAX_PLATFORMS=cpu`` as the JAX package does, and
restores its own environment exactly afterwards."""
import contextlib
import os

#: what a child sees while the pool is made
_CHILD_ENV = {"CUDA_VISIBLE_DEVICES": "", "JAX_PLATFORMS": "cpu"}


@contextlib.contextmanager
def cpu_only_child_env():
    saved = {k: os.environ.get(k) for k in _CHILD_ENV}
    os.environ.update(_CHILD_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
