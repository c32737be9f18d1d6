"""Native libraries are keyed by source, flags and host."""
import os

from asr_craft.utils import native_build as nb


def test_key_changes_with_flags(monkeypatch):
    a = nb.library_path("craftio", "pfile_io.cpp")
    monkeypatch.setattr(nb, "CXXFLAGS", nb.CXXFLAGS + ("-DX=1",))
    assert nb.library_path("craftio", "pfile_io.cpp") != a


def test_key_changes_with_source_and_host(monkeypatch, tmp_path):
    src = tmp_path / "x.cpp"
    src.write_text("int f() { return 1; }\n")
    monkeypatch.setattr(nb, "NATIVE_DIR", str(tmp_path))
    a = nb.library_path("x", "x.cpp")
    assert os.path.dirname(a) == str(tmp_path)
    src.write_text("int f() { return 2; }\n")
    b = nb.library_path("x", "x.cpp")
    monkeypatch.setattr(nb, "_host_id", lambda: "another host")
    assert len({a, b, nb.library_path("x", "x.cpp")}) == 3


def test_build_compiles_once(monkeypatch, tmp_path):
    (tmp_path / "x.cpp").write_text('extern "C" int f() { return 7; }\n')
    monkeypatch.setattr(nb, "NATIVE_DIR", str(tmp_path))
    path = nb.build("x", "x.cpp")
    mtime = os.path.getmtime(path)
    assert nb.build("x", "x.cpp") == path
    assert os.path.getmtime(path) == mtime
    import ctypes
    assert ctypes.CDLL(path).f() == 7
