"""The port's kernel build (``ops/_build.py``) without nvcc: a library's
name hashes its source, every shared header and the flags, so an edited
header is never served from a stale library."""
from paddle_tpu_torch.ops import _build


def test_target_changes_with_a_shared_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = _build._target("kern")
    assert _build._target("kern") == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _build._target("kern")
    assert second != first
    assert second.parent == _build.BUILD_DIR
    assert second.name.startswith("kern-") and second.suffix == ".so"
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert _build._target("kern") != second
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n// edit\n')
    assert _build._target("kern") not in (first, second)


def test_sources_lists_kernels_not_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    for name in ("b.cu", "a.cu", "shared.cuh"):
        (tmp_path / name).write_text("")
    assert _build.sources() == ["a", "b"]

