"""The port's shared nvcc build helper (``repro_torch/kernels/_build.py``),
driven on the CPU through a stand-in ``nvcc`` script: where the library
lands, that a build is reused, that new flags, a new source or an edited
header beside it rebuild, that a failed compile raises with the compiler's message, that
``build_all`` returns in the order given, and that every kernel of the
port builds through it for sm_90a."""
import importlib
import pathlib

import pytest

from repro_torch import kernels
from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: count the call, honour -o, fail on a source with FAIL
echo call >> "$(dirname "$0")/calls"
src=""; out=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift ;; *.cu) src="$1" ;; esac; shift
done
if grep -q FAIL "$src"; then echo "error: bad source" >&2; exit 2; fi
echo "ptxas info    : Used 10 registers" >&2
echo lib > "$out"
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(home))
    return home / "bin" / "calls"


def kernel_source(root: pathlib.Path, name: str, text: str) -> pathlib.Path:
    src = root / name / "csrc" / f"{name}.cu"
    src.parent.mkdir(parents=True)
    src.write_text(text)
    return src


def test_build_places_reuses_and_rebuilds(tmp_path, fake_cuda):
    src = kernel_source(tmp_path, "k", "__global__ void k() {}\n")
    lib, report = _build.build(src, _build.SM90A_FLAGS)
    assert lib.parent.parent == tmp_path / "k" / "build"
    assert lib.name == "libk.so" and lib.exists()
    assert "Used 10 registers" in report
    assert _build.build(src, _build.SM90A_FLAGS) == (lib, report)
    assert fake_cuda.read_text().count("call") == 1      # reused
    lib2, _ = _build.build(src, _build.SM90A_FLAGS + ("--fmad=false",))
    src.write_text("__global__ void k2() {}\n")
    lib3, _ = _build.build(src, _build.SM90A_FLAGS)
    assert len({lib, lib2, lib3}) == 3
    assert fake_cuda.read_text().count("call") == 3


def test_header_edit_rebuilds(tmp_path, fake_cuda):
    """The hash covers every file in ``csrc/``: a header the source
    includes, edited, gives a new build; a new header does too."""
    src = kernel_source(tmp_path, "k", '#include "k_impl.cuh"\n')
    header = src.parent / "k_impl.cuh"
    header.write_text("// first\n")
    lib, _ = _build.build(src, _build.SM90A_FLAGS)
    assert _build.build(src, _build.SM90A_FLAGS)[0] == lib
    assert fake_cuda.read_text().count("call") == 1      # reused
    header.write_text("// second\n")
    lib2, _ = _build.build(src, _build.SM90A_FLAGS)
    (src.parent / "k_more.cuh").write_text("// new\n")
    lib3, _ = _build.build(src, _build.SM90A_FLAGS)
    assert len({lib, lib2, lib3}) == 3 and lib3.exists()
    assert fake_cuda.read_text().count("call") == 3


def test_build_raises_with_the_compiler_message(tmp_path, fake_cuda):
    src = kernel_source(tmp_path, "bad", "FAIL\n")
    with pytest.raises(RuntimeError, match="bad source"):
        _build.build(src, _build.SM90A_FLAGS)
    assert not list((tmp_path / "bad" / "build").rglob("*.so"))


def test_build_all_keeps_order(tmp_path, fake_cuda):
    srcs = [kernel_source(tmp_path, n, f"// {n}\n") for n in ("a", "b", "c")]
    out = _build.build_all([lambda s=s: _build.build(s, _build.SM90A_FLAGS)
                            for s in srcs])
    assert [lib.name for lib, _ in out] == ["liba.so", "libb.so", "libc.so"]


def test_no_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    src = kernel_source(tmp_path, "k", "\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(src, _build.SM90A_FLAGS)


REPORT = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5fa_tc9fa_fwd_tcILi128EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN5fa_tc9fa_fwd_tcILi128EEEv
    16 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes smem, 392 bytes cmem[0]
"""


def test_ptxas_report_by_function():
    assert _build.ptxas_functions(REPORT) == {
        "_ZN5fa_tc9fa_fwd_tcILi128EEEv": dict(
            stack=16, spill_stores=16, spill_loads=24, registers=168),
        "_Z1kPf": dict(stack=0, spill_stores=0, spill_loads=0,
                       registers=64, smem=16)}
    assert _build.ptxas_functions("no report") == {}


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_every_kernel_builds_for_sm90a(name, tmp_path, fake_cuda,
                                       monkeypatch):
    """Each kernel's ``ops.build`` compiles its ``SOURCE`` with flags that
    start with the shared sm_90a set (a copy of the source, built under
    the test's directory)."""
    ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    assert ops.SOURCE.exists()
    assert ops.NVCC_FLAGS[:len(_build.SM90A_FLAGS)] == _build.SM90A_FLAGS
    src = kernel_source(tmp_path, name, ops.SOURCE.read_text())
    monkeypatch.setattr(ops, "SOURCE", src)
    lib, report = ops.build()
    assert lib.parent.parent == tmp_path / name / "build"
    assert lib.name == f"lib{name}.so" and lib.exists()
    assert "registers" in report


def test_cycle_kernels_build_two_libraries(tmp_path, fake_cuda,
                                           monkeypatch):
    """The cycle kernels build as two libraries from one source, side by
    side in ``build_all``: the whole grid's instances and, under
    ``-DCCA_TILES=1``, the tile instances."""
    ops = importlib.import_module("repro_torch.kernels.cca_cycle.ops")
    assert ops.TILE_FLAGS == ops.NVCC_FLAGS + ("-DCCA_TILES=1",)
    src = kernel_source(tmp_path, "cca_cycle", ops.SOURCE.read_text())
    monkeypatch.setattr(ops, "SOURCE", src)
    whole, tiles = ops.build()[0], ops.build_tiles()[0]
    assert whole != tiles and whole.name == tiles.name == "libcca_cycle.so"
    assert fake_cuda.read_text().count("call") == 2
    monkeypatch.setattr(kernels, "KERNELS", ("cca_cycle",))
    assert [lib for lib, _ in kernels.build_all()] == [whole, tiles]
    assert fake_cuda.read_text().count("call") == 2        # both reused
