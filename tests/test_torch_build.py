"""The kernel library's build directory and files are checked before
``nvcc`` runs and before ``ctypes`` loads anything
(``routest_tpu_torch/ops/build.py``), with the policy the JAX package
applies to its native library (``utils/paths.secure_user_cache_dir``):
a directory that is a symlink, not ours, or group- or world-writable,
and a library that is not ours or group- or world-writable, are
refused by raising. Runs without ``nvcc``: a fake compiler stands in
where a build must happen, and a refusal must come before the compiler
is even looked up.
"""

import hashlib
import os
import stat
import sys

import pytest

from routest_tpu_torch.ops import build as kbuild


def _no_compiler():
    raise AssertionError("nvcc looked up past a refusal")


@pytest.fixture()
def cache(monkeypatch, tmp_path):
    """The override directory (``RTPU_KERNEL_CACHE``) under ``tmp_path``;
    the compiler lookup fails the test."""
    path = tmp_path / "kernels"
    monkeypatch.setenv("RTPU_KERNEL_CACHE", str(path))
    monkeypatch.setattr(kbuild, "find_nvcc", _no_compiler)
    monkeypatch.setattr(kbuild, "_lib", None)
    return path


def _fake_nvcc(tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "sys.stderr.write(\"ptxas info    : Used 48 registers\\n\")\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return str(fake)


def _library_path(directory, name="fused_eta"):
    """Where ``build`` keeps ``name``'s library in ``directory``."""
    src = os.path.join(os.path.dirname(kbuild.__file__), "csrc", f"{name}.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(kbuild.NVCC_FLAGS).encode())
    return os.path.join(str(directory),
                        f"lib{name}-{key.hexdigest()[:16]}.so")


def test_the_override_names_the_directory(cache, monkeypatch):
    assert kbuild.build_dir() == str(cache)
    monkeypatch.delenv("RTPU_KERNEL_CACHE")
    assert kbuild.build_dir() == kbuild.BUILD_DIR


@pytest.mark.parametrize("mode", [0o770, 0o777, 0o702],
                         ids=["group", "world", "world-only"])
@pytest.mark.parametrize("entry", ["build", "load_library"])
def test_a_writable_directory_is_refused_before_nvcc(cache, mode, entry):
    cache.mkdir()
    cache.chmod(mode)
    with pytest.raises(kbuild.UntrustedBuildPath,
                       match="group- or world-writable") as err:
        getattr(kbuild, entry)()
    assert str(cache) in str(err.value)
    assert kbuild._lib is None


def test_a_symlinked_directory_is_refused(cache, tmp_path):
    real = tmp_path / "elsewhere"
    real.mkdir(mode=0o700)
    cache.symlink_to(real, target_is_directory=True)
    with pytest.raises(kbuild.UntrustedBuildPath, match="symlink"):
        kbuild.build("fused_eta")


def test_a_directory_of_another_user_is_refused(cache, monkeypatch):
    cache.mkdir(mode=0o700)
    uid = os.getuid()
    monkeypatch.setattr(kbuild.os, "getuid", lambda: uid + 1)
    with pytest.raises(kbuild.UntrustedBuildPath, match="owned by uid"):
        kbuild.build("fused_eta")


@pytest.mark.parametrize("mode", [0o775, 0o757, 0o666],
                         ids=["group", "world", "rw-all"])
@pytest.mark.parametrize("entry", ["build", "load_library"])
def test_a_writable_library_is_refused(cache, mode, entry):
    """A library planted under the name a build would give, with its
    report beside it, is refused before anything is loaded."""
    cache.mkdir(mode=0o700)
    lib = _library_path(cache)
    with open(lib, "w") as f:
        f.write("planted")
    os.chmod(lib, mode)
    with open(lib + ".ptxas.txt", "w") as f:
        f.write("ptxas info    : Used 48 registers\n")
    with pytest.raises(kbuild.UntrustedBuildPath, match=lib):
        getattr(kbuild, entry)()
    assert kbuild._lib is None


def test_a_symlinked_library_is_refused(cache, tmp_path):
    cache.mkdir(mode=0o700)
    target = tmp_path / "planted.so"
    target.write_text("planted")
    target.chmod(0o700)
    lib = _library_path(cache)
    os.symlink(target, lib)
    with open(lib + ".ptxas.txt", "w") as f:
        f.write("report")
    with pytest.raises(kbuild.UntrustedBuildPath, match="symlink"):
        kbuild.build("fused_eta")


def test_a_library_of_another_user_is_refused_at_load(cache, monkeypatch,
                                                      tmp_path):
    """``load_library`` checks the file again just before loading it."""
    cache.mkdir(mode=0o700)
    lib = _library_path(cache)
    monkeypatch.setattr(kbuild, "build", lambda name: (lib, ""))
    with open(lib, "w") as f:
        f.write("planted")
    os.chmod(lib, 0o700)
    uid = os.getuid()
    monkeypatch.setattr(kbuild.os, "getuid", lambda: uid + 1)
    with pytest.raises(kbuild.UntrustedBuildPath, match="owned by uid"):
        kbuild.load_library()


def test_a_fresh_directory_is_private_and_its_library_not_writable(
        cache, monkeypatch, tmp_path):
    """A missing directory is made ``0700``; the compiler's output is
    made ``0700`` whatever the umask, so the next run trusts it."""
    monkeypatch.setattr(kbuild, "find_nvcc", lambda: _fake_nvcc(tmp_path))
    old = os.umask(0o002)
    try:
        path, report = kbuild.build("fused_eta")
    finally:
        os.umask(old)
    assert stat.S_IMODE(os.stat(cache).st_mode) == 0o700
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o700
    assert path == _library_path(cache) and "Used 48 registers" in report
    monkeypatch.setattr(kbuild, "find_nvcc", _no_compiler)
    assert kbuild.build("fused_eta") == (path, report)
