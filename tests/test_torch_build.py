"""The port's kernel build (``ray_tpu_torch/ops/_build.py``), without
``nvcc``: a library's name is keyed by its source, every shared header
(``csrc/*.cuh``) and the compiler flags, so an edited header rebuilds
every source that may include it; only ``.cu`` files are kernel sources.
"""

import pytest

pytest.importorskip("torch")

from ray_tpu_torch.ops import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "alpha.cu").write_text('#include "shared.cuh"\n')
    (src / "beta.cu").write_text("// beta\n")
    (src / "shared.cuh").write_text("// helpers v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_all_kernels_lists_sources_only(csrc):
    (csrc / "other.cuh").write_text("// another header\n")
    assert _build.all_kernels() == ["alpha", "beta"]


@pytest.mark.parametrize("edit", ["header", "new_header", "source",
                                  "flags"])
def test_artifact_name_follows_what_the_build_reads(csrc, monkeypatch,
                                                    edit):
    before = {n: _build._artifact(n) for n in ("alpha", "beta")}
    assert before == {n: _build._artifact(n) for n in ("alpha", "beta")}
    if edit == "header":
        (csrc / "shared.cuh").write_text("// helpers v2\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// more helpers\n")
    elif edit == "source":
        (csrc / "alpha.cu").write_text('#include "shared.cuh"\n// edit\n')
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    after = {n: _build._artifact(n) for n in ("alpha", "beta")}
    assert after["alpha"] != before["alpha"]
    # A header may be included by any source; a source edit touches only
    # its own library.
    assert (after["beta"] != before["beta"]) == (edit != "source")
    for name, path in after.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"


def test_build_log_is_empty_before_a_build(csrc):
    assert _build.build_log("alpha") == ""
