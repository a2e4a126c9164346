"""The kernel build cache of the port (``paddle_tpu_torch/ops/kernels/
_build.py``), on the CPU: no nvcc is run. A library's target path is a
hash of its source, the shared headers and the flags, so an edited
header must give a new path and an unchanged tree the same one."""
import pytest

from paddle_tpu_torch.ops.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "hopper.cuh"\nint x;\n')
    (d / "hopper.cuh").write_text("// helpers, first version\n")
    monkeypatch.setattr(_build, "CSRC", d)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    return d


def test_target_is_stable_for_an_unchanged_tree(csrc):
    first = _build._target("k")
    assert _build._target("k") == first
    assert first.parent == _build.BUILD
    assert first.name.startswith("k-") and first.suffix == ".so"


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_target_changes_with_sources_and_headers(csrc, edit):
    before = _build._target("k")
    if edit == "header":
        (csrc / "hopper.cuh").write_text("// helpers, second version\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("// another shared header\n")
    else:
        (csrc / "k.cu").write_text('#include "hopper.cuh"\nint y;\n')
    assert _build._target("k") != before


def test_target_returns_when_the_header_is_restored(csrc):
    before = _build._target("k")
    (csrc / "hopper.cuh").write_text("// helpers, second version\n")
    assert _build._target("k") != before
    (csrc / "hopper.cuh").write_text("// helpers, first version\n")
    assert _build._target("k") == before


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z9fwd_wgmmaILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z9fwd_wgmmaILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 928 bytes cmem[0]
ptxas info    : Compiling entry function '_Z9dkv_wgmmaILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z9dkv_wgmmaILi128EEvv
    8 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 240 registers, used 1 barriers, 928 bytes cmem[0]
"""


def test_ptxas_report_reads_the_build_log(csrc):
    assert _build.ptxas_report("k") == {}      # built before logs, or never
    log = _build._target("k").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(PTXAS_LOG)
    assert _build.ptxas_report("k") == {
        "_Z9fwd_wgmmaILi128EEvv": dict(registers=168, spill_stores=0,
                                      spill_loads=0),
        "_Z9dkv_wgmmaILi128EEvv": dict(registers=240, spill_stores=24,
                                      spill_loads=16)}


def test_flags_keep_the_sm90a_target():
    """wgmma exists only for sm_90a, not plain sm_90."""
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS
    assert {"-Xptxas", "-v"} <= set(_build.FLAGS)
