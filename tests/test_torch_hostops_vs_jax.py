"""The port's host library (csrc/host_ops.cpp, built by
ops/_build.host_library) held against the JAX chain: the JAX package's
host-library cases, tests/test_hostops.py (the C++ preprocess and revert
against JAX's clip -> z-score -> resize -> bf16 chain and index rule, the
turbo host route against the device route) and tests/test_turbo_stream.py
(the streamed pipeline against the fused one), run here with the JAX
package's ctypes wrapper pointed at the port's build. They run in a
checkout without engine/build/libfnn_hostops.so, where the JAX files skip.
The wrapper's module state is restored after this module, and the JAX
work compiles without the persistent cache, so the other JAX tests in the
worker see what they saw before."""
import pytest

from fast_nnunet_tpu.utils import hostops
from fast_nnunet_tpu_torch.ops import _build

from . import test_hostops, test_turbo_stream
from .torch_port_common import no_persistent_compile_cache  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _port_library():
    saved = (hostops._CANDIDATES, hostops._LIB, hostops._TRIED)
    hostops._CANDIDATES = (_build.host_library()._name,)
    hostops._LIB, hostops._TRIED = None, False
    try:
        assert hostops.available() and hostops.has_box()
        yield
    finally:
        hostops._CANDIDATES, hostops._LIB, hostops._TRIED = saved


for _module in (test_hostops, test_turbo_stream):
    globals().update({name: fn for name, fn in vars(_module).items()
                      if name.startswith("test_")})
