"""The port's native image loader (mvdfusion_tpu_torch/native/) against the
JAX package's (mvdfusion_tpu/native/): the same loader.cc arithmetic built
with the same flags, so decode_batch must give the same floats (atol 0) on
every case: RGB and RGBA png with and without the white composite, a gray
png, a 16-bit depth png read with one channel, a jpg and a non-square
image, each read at its stored size, downscaled by an integer ratio (64 ->
32) and by a non-integer one (64 -> 24), and upscaled (24 -> 48); one and
four threads alike. Skipped only where the JAX package's library is itself
unavailable (as tests/test_data.py skips). Then the port's own rules: the
build into build/, a failed build remembered with its reason, a refused
file named in the error.
"""

import numpy as np
import pytest
from PIL import Image

import mvdfusion_tpu.native as jnative
from mvdfusion_tpu_torch import native

# name -> (height, width, writer of a random image of that size to a path)
KINDS = {
    "rgb_png": lambda rng, h, w, p: Image.fromarray(_u8(rng, h, w, 3)).save(p),
    "rgba_png": lambda rng, h, w, p: Image.fromarray(_u8(rng, h, w, 4), "RGBA").save(p),
    "gray_png": lambda rng, h, w, p: Image.fromarray(_u8(rng, h, w, 1)[..., 0], "L").save(p),
    "depth_png": lambda rng, h, w, p: Image.fromarray((rng.uniform(size=(h, w)) * 510).astype(np.uint16)).save(p),
    "jpg": lambda rng, h, w, p: Image.fromarray(_u8(rng, h, w, 3)).save(p, quality=90),
}
SUFFIX = {"jpg": ".jpg"}
# (stored h, stored w) -> (out h, out w): stored size, integer and non-integer downscale, upscale
SIZES = {"stored": ((64, 64), (64, 64)), "down2": ((64, 64), (32, 32)), "down_frac": ((64, 64), (24, 24)),
         "up": ((24, 24), (48, 48)), "nonsquare": ((64, 40), (24, 36))}


def _u8(rng, h, w, c):
    return (rng.uniform(size=(h, w, c)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_loader():
    if not jnative.available():
        pytest.skip("the JAX package's native loader is not built on this box")
    return jnative


def _write(tmp_path, kind, h, w, seed=0, name="img"):
    p = str(tmp_path / f"{name}_{kind}_{h}x{w}{SUFFIX.get(kind, '.png')}")
    KINDS[kind](np.random.default_rng(seed), h, w, p)
    return p


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kind,out_c,composite", [
    ("rgb_png", 3, False), ("rgb_png", 3, True), ("rgba_png", 3, False), ("rgba_png", 3, True),
    ("rgba_png", 4, True), ("gray_png", 3, False), ("depth_png", 1, False), ("jpg", 3, False)])
def test_decode_batch_equals_jax(tmp_path, jax_loader, kind, out_c, composite, size):
    (h, w), (oh, ow) = SIZES[size]
    paths = [_write(tmp_path, kind, h, w, seed=s, name=f"s{s}") for s in range(2)]
    ours = native.decode_batch(paths, oh, ow, out_c, white_composite=composite, n_threads=2)
    ref = jax_loader.decode_batch(paths, oh, ow, out_c, white_composite=composite, n_threads=2)
    assert ours.shape == (2, oh, ow, out_c) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    if kind == "depth_png":
        assert ours.max() > 1.0  # 16-bit samples / 255
    if kind == "rgba_png" and composite and out_c == 3:
        assert (ours == 1.0).all(axis=-1).any()  # some pixels went white


def test_threads_agree(tmp_path, jax_loader):
    """A batch of 9 files of mixed kinds on 1 and 4 threads: equal, and equal
    to the JAX package's on 4."""
    paths = [_write(tmp_path, k, 40, 40, seed=s, name=f"t{s}") for s in range(3)
             for k in ("rgb_png", "rgba_png", "jpg")]
    one = native.decode_batch(paths, 24, 24, 3, white_composite=True, n_threads=1)
    four = native.decode_batch(paths, 24, 24, 3, white_composite=True, n_threads=4)
    np.testing.assert_array_equal(one, four)
    np.testing.assert_array_equal(four, jax_loader.decode_batch(paths, 24, 24, 3, white_composite=True, n_threads=4))


def test_build_writes_the_library_under_build(tmp_path, monkeypatch):
    """build() compiles loader.cc into the given path and reports it; a
    second call finds it fresh; an older library is rebuilt."""
    import os

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libmvdf_loader.so")
    info = native.build()
    assert info["built"] and info["path"] == str(tmp_path / "libmvdf_loader.so") and info["seconds"] > 0
    assert native.build() == {"seconds": 0.0, "path": info["path"], "built": False}
    old = native.SOURCE.stat().st_mtime - 10
    os.utime(native.LIB_PATH, (old, old))
    assert native.build()["built"]
    assert [p.name for p in tmp_path.iterdir()] == ["libmvdf_loader.so"]  # the temporary library renamed


def test_failed_build_is_remembered(tmp_path, monkeypatch):
    """With no compiler the build raises with the command; available() is
    False, tries once, and reason() says why; decode_batch refuses."""
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libmvdf_loader.so")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_why", None)
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.build()
    assert not native.available() and "no-such-g" in native.reason()
    monkeypatch.setattr(native, "CXX", "g++")  # a compiler now: still no second try in this process
    assert not native.available() and not native.LIB_PATH.exists()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode_batch([str(tmp_path / "a.png")], 8, 8)


def test_compiler_error_carries_its_output(tmp_path, monkeypatch):
    src = tmp_path / "loader.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libmvdf_loader.so")
    with pytest.raises(RuntimeError, match="failed:\n.*error"):
        native.build()
    assert not native.LIB_PATH.exists() and [p.name for p in tmp_path.iterdir()] == ["loader.cc"]


@pytest.mark.parametrize("bad", ["truncated", "missing", "not_an_image"])
def test_refused_file_is_named(tmp_path, bad):
    good = _write(tmp_path, "jpg", 32, 32)
    p = tmp_path / f"bad_{bad}.jpg"
    if bad == "truncated":
        p.write_bytes(open(good, "rb").read()[:40])
    elif bad == "not_an_image":
        p.write_text("plain text, long enough to read eight bytes")
    with pytest.raises(native.DecodeError, match=f"1 of 3 files: {p}$"):
        native.decode_batch([good, str(p), good], 16, 16, 3)


@pytest.mark.parametrize("shape", [(0, 8, 3), (8, 8, 5), (8, 8, 0)])
def test_output_shape_is_checked(tmp_path, shape):
    with pytest.raises(ValueError, match="sizes >= 1"):
        native.decode_batch([_write(tmp_path, "jpg", 16, 16)], *shape)


def test_concurrent_first_use_builds_once(tmp_path, monkeypatch):
    """Eight Python threads (more than this box's cores with the suite's
    workers) reach a fresh library at once, the interpreter switching every
    microsecond: one build, every thread gets the library, and their decodes
    (the interpreter lock released inside the call) equal a serial one."""
    import sys
    import threading

    good = [_write(tmp_path, k, 32, 32, seed=s, name=f"c{s}") for s in range(2) for k in ("rgba_png", "jpg")]
    want = native.decode_batch(good, 20, 20, 3, white_composite=True, n_threads=1)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "libmvdf_loader.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_why", None)
    builds, build = [], native.build
    monkeypatch.setattr(native, "build", lambda *a, **k: builds.append(build(*a, **k)["built"]))
    got = [None] * 8

    def work(i):
        got[i] = native.decode_batch(good, 20, 20, 3, white_composite=True, n_threads=2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert builds == [True] and native.reason() is None
    for g in got:
        np.testing.assert_array_equal(g, want)
