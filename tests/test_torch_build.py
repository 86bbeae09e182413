"""The build of the port's hand-written native code (``utils/build.py``), on
the CPU: each CUDA kernel class names its own source in ``csrc/``, and its
library's path depends on that source and on every header it includes from
its own directory; the g++ engine's library (``envs/native.py``) is keyed
the same way by its source and flags. Nothing here runs nvcc."""
import hashlib

import pytest

from etmppo_tpu_torch.envs import native
from etmppo_tpu_torch.envs.mortar_mayhem import MortarMayhemReset
from etmppo_tpu_torch.envs.mystery_path import MysteryPathReset
from etmppo_tpu_torch.ops import window_attention as wa
from etmppo_tpu_torch.utils import build
from etmppo_tpu_torch.utils.profiling import PhaseStamp

KERNELS = (wa.WindowAttentionForward, wa.WindowAttentionBackward,
           wa.WindowAttentionForwardGrouped, wa.WindowAttentionBackwardGrouped,
           MysteryPathReset, MortarMayhemReset, PhaseStamp)
# The headers each kernel includes from csrc/.
HEADERS = {
    wa.WindowAttentionForward: ("window_ring.cuh",),
    wa.WindowAttentionBackward: ("window_ring.cuh",),
    wa.WindowAttentionForwardGrouped: ("window_ring.cuh", "window_runs.cuh"),
    wa.WindowAttentionBackwardGrouped: ("window_ring.cuh", "window_runs.cuh"),
}


def _library(cls, source, build_dir):
    """The library path of ``source`` built as ``cls`` builds it (None:
    g++'s native engine)."""
    if cls is None:
        return build.library_path(source, native.GXX_FLAGS, build_dir)
    return cls(source, build_dir).library_path()


@pytest.mark.parametrize("cls", KERNELS + (None,),
                         ids=[k.symbol for k in KERNELS] + ["env_batch"])
def test_a_library_depends_on_its_source(cls, tmp_path):
    source = native.SOURCE if cls is None else cls().source
    assert source.exists() and source.parent == build.CSRC
    if cls is not None:
        assert source == cls.default_source
    src = tmp_path / source.name
    src.write_text("// a")
    a = _library(cls, src, tmp_path / "build")
    src.write_text("// b")
    b = _library(cls, src, tmp_path / "build")
    assert a != b and a.parent == tmp_path / "build"
    assert a.name.startswith(source.stem + "_") and a.suffix == ".so"
    if cls is None:   # the name the engine's library has always had
        digest = hashlib.sha256(native.SOURCE.read_bytes() + " ".join(
            native.GXX_FLAGS).encode()).hexdigest()[:16]
        assert native.library_path() == (build.BUILD_DIR
                                         / f"env_batch_{digest}.so")


@pytest.mark.parametrize("cls,header", [(cls, h) for cls, hs in
                                        HEADERS.items() for h in hs],
                         ids=[f"{cls.symbol}-{h}" for cls, hs in
                              HEADERS.items() for h in hs])
def test_a_library_depends_on_each_header_it_includes(cls, header, tmp_path):
    source = cls().source
    assert f'#include "{header}"' in source.read_text()
    (tmp_path / source.name).write_text(source.read_text())
    for h in HEADERS[cls]:
        (tmp_path / h).write_text((build.CSRC / h).read_text())
    first = _library(cls, tmp_path / source.name, tmp_path / "build")
    (tmp_path / header).write_text((build.CSRC / header).read_text()
                                   + "\n// x")
    second = _library(cls, tmp_path / source.name, tmp_path / "build")
    assert first != second
