"""The port's clip loader (``data/native_loader.py``, decode threads over
Python cv2) against the JAX package's ``NativeClipLoader`` (ctypes over
``native/frame_loader.cpp``, built from C++ OpenCV here).

The JAX library is taken by ``load_library("loader")`` inside a fixture
under an ``fcntl.flock`` on a lock file in pytest's base temp root, so
xdist workers never run ``make`` on one target together; the tests skip
only where that returns None.

- PNG images in both crop modes, at sizes that shrink, stretch and crop:
  equal bit for bit;
- an MJPG clip written with cv2 (grab / retrieve up to each index, both
  crop modes): every byte within ``MJPG_MAX_DIFF`` (the two decoders'
  libjpeg may differ; measured 0 with OpenCV 4.6 (C++) and cv2 5.0.0);
- four clips and one missing path: ids 0-4, one ``IOError``;
- ``next`` times out with ``TimeoutError``;
- with a slow decoder stubbed in, done plus in-flight decodes never exceed
  ``capacity``;
- 32 threads on a short switch interval: every id once, the capacity held;
- the port's loader runs no process and leaves ``native/build`` as it was.
"""

import fcntl
import os
import subprocess
import threading
import time

import numpy as np
import pytest

from followyourclick_tpu_torch.data import native_loader as tloader

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MJPG_MAX_DIFF = 1


@pytest.fixture(scope="module")
def jax_loader_class(tmp_path_factory):
    root = tmp_path_factory.getbasetemp().parent
    with open(root / "native_loader.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            from followyourclick_tpu.native import load_library

            if load_library("loader") is None:
                pytest.skip("the JAX package's native loader does not build")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    from followyourclick_tpu.data.native_loader import NativeClipLoader

    return NativeClipLoader


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    rs = np.random.RandomState(0)
    paths = {}
    for name, (h, w) in {"small": (100, 80), "wide": (333, 517)}.items():
        img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
        paths[name] = str(d / f"{name}.png")
        cv2.imwrite(paths[name], img)
    paths["clip"] = str(d / "clip.avi")
    writer = cv2.VideoWriter(paths["clip"], cv2.VideoWriter_fourcc(*"MJPG"),
                             8, (96, 72))
    for _ in range(12):
        frame = cv2.GaussianBlur(
            (rs.rand(72, 96, 3) * 255).astype(np.uint8), (7, 7), 2)
        writer.write(frame)
    writer.release()
    return paths


def pair_of(cls, requests, workers=2):
    """Each request's frames from the JAX loader and the port's."""
    jax_loader, port = cls(workers), tloader.NativeClipLoader(workers)
    try:
        out = []
        for req in requests:
            assert jax_loader.submit(*req) == port.submit(*req)
            jid, want = jax_loader.next()
            pid, got = port.next()
            assert jid == pid
            out.append((want, got))
        return out
    finally:
        jax_loader.close()
        port.close()


@pytest.mark.parametrize("crop_mode", [0, 1])
def test_images_equal_the_jax_loader(jax_loader_class, media, crop_mode):
    requests = [(media[name], None, hw, crop_mode)
                for name in ("small", "wide")
                for hw in ((64, 64), (128, 96), (77, 301), (256, 256))]
    for (want, got), req in zip(pair_of(jax_loader_class, requests),
                                requests):
        assert got.shape == want.shape == (1,) + req[2] + (3,)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(req))


def test_mjpg_clip_within_bound_of_the_jax_loader(jax_loader_class, media):
    requests = [(media["clip"], [7, 0, 3, 11], (48, 64), 0),
                (media["clip"], [5, 1], (72, 96), 1),
                (media["clip"], [2], (33, 50), 1),
                (media["clip"], range(12), (60, 60), 0)]
    worst = 0
    for (want, got), req in zip(pair_of(jax_loader_class, requests),
                                requests):
        assert got.shape == want.shape == (len(req[1]),) + req[2] + (3,)
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
    print(f"MJPG: largest byte difference {worst}")
    assert worst <= MJPG_MAX_DIFF


def test_four_clips_and_a_missing_path(media, tmp_path):
    loader = tloader.NativeClipLoader(num_workers=3)
    ids = [loader.submit(media["clip"], [0, 1], (32, 32)) for _ in range(4)]
    bad = loader.submit(str(tmp_path / "missing.mp4"), [0], (32, 32))
    assert ids + [bad] == list(range(5))
    got, errors = set(), []
    for _ in range(5):
        try:
            rid, clip = loader.next()
            got.add(rid)
            assert clip.shape == (2, 32, 32, 3)
        except IOError as e:
            errors.append(str(e))
    loader.close()
    assert got == set(ids)
    assert errors == [f"native loader: decode failed (status -1) for "
                      f"request {bad}"]


def test_frame_out_of_range_and_timeout(media):
    loader = tloader.NativeClipLoader(num_workers=1)
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            loader.next(timeout_ms=100)
        assert time.monotonic() - t0 >= 0.09
        rid = loader.submit(media["clip"], [3, 40], (32, 32))
        with pytest.raises(IOError, match=f"status -2\\) for request {rid}"):
            loader.next()
    finally:
        loader.close()


def test_capacity_bounds_done_and_in_flight(monkeypatch):
    """Each decode, as it starts, reads the loader's done and in-flight
    count under its lock, as do the pops: the capacity bounds it."""
    capacity, seen = 3, []
    loader = None

    def in_flight():
        with loader._cv:
            return len(loader._done) + loader._decoding

    def slow(path, frame_indices, out_hw, crop_mode):
        seen.append(in_flight())
        time.sleep(0.02)
        return tloader.OK, np.full((1,) + tuple(out_hw) + (3,), int(path),
                                   np.uint8)

    monkeypatch.setattr(tloader, "decode", slow)
    loader = tloader.NativeClipLoader(num_workers=5, capacity=capacity)
    ids = [loader.submit(str(i), None, (2, 2)) for i in range(12)]
    time.sleep(0.3)   # every decode the capacity allows has run
    assert in_flight() == capacity and len(seen) == capacity
    got = []
    for _ in ids:
        rid, frames = loader.next()
        assert frames[0, 0, 0, 0] == rid
        got.append(rid)
        assert in_flight() <= capacity
    loader.close()
    assert sorted(got) == ids
    assert len(seen) == 12 and max(seen) <= capacity


def test_stress_more_workers_than_cores(monkeypatch):
    """32 workers on a short switch interval, 200 requests of an instant
    decoder: every id comes back once, and done plus in flight never
    passes the capacity (a lost update of the count would break one)."""
    import sys

    capacity, seen = 5, []
    loader = None

    def instant(path, frame_indices, out_hw, crop_mode):
        with loader._cv:
            seen.append(len(loader._done) + loader._decoding)
        return tloader.OK, np.zeros((1, 1, 1, 3), np.uint8)

    monkeypatch.setattr(tloader, "decode", instant)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = tloader.NativeClipLoader(num_workers=32, capacity=capacity)
        ids = [loader.submit(str(i), None, (1, 1)) for i in range(200)]
        got = [loader.next(timeout_ms=10000)[0] for _ in ids]
        loader.close()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(got) == ids
    assert len(seen) == 200 and max(seen) <= capacity
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t.name.startswith("clip-loader-"))


def test_port_loader_builds_nothing(media, monkeypatch):
    build = os.path.join(REPO, "native", "build")

    def listing():
        if not os.path.isdir(build):
            return None
        return {n: os.stat(os.path.join(build, n)).st_mtime_ns
                for n in os.listdir(build)}

    before = listing()

    def refuse(*args, **kwargs):
        raise AssertionError(f"the loader started a process: {args}")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    loader = tloader.NativeClipLoader(2)
    loader.submit(media["small"], None, (16, 16))
    loader.submit(media["clip"], [0], (16, 16), 1)
    assert {loader.next()[0] for _ in range(2)} == {0, 1}
    loader.close()
    assert listing() == before
