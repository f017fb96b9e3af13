"""Twin of ``tests/test_examples.py``: run every ``examples/torch_*.py`` demo
of the port as a subprocess under ``SV_DEVICE=cpu`` (the demos otherwise
take the card), with the mock ffmpeg binary, and check its success marker.
The skip conditions where a codec is missing are the JAX test's."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
MOCK_FFMPEG = os.path.join(REPO, "tests", "mock_ffmpeg.py")


def _demo_env():
    env = dict(os.environ)
    env["SV_DEVICE"] = "cpu"
    # many small torch ops: one intra-op thread, so that a demo sharing its
    # cores with other test workers waits on no OpenMP barrier
    env["OMP_NUM_THREADS"] = "1"
    env["SWIFTVIDEO_FFMPEG"] = MOCK_FFMPEG
    return env


def _run(name, *argv, env=None, timeout=240):
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, name), *argv],
        env=env or _demo_env(), cwd=REPO, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, (
        f"{name} exited {proc.returncode}\n--- stdout\n{proc.stdout}"
        f"\n--- stderr\n{proc.stderr}")
    return proc.stdout


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _libav():
    from swiftvideo_tpu_torch.codec.libav import libav_available
    if not libav_available():
        pytest.skip("libav shim not available")


def test_mixing_demo(tmp_path):
    out = _run("torch_mixing_demo.py", str(tmp_path))
    assert "wrote" in out and "frame.png" in out and "on cpu" in out
    assert (tmp_path / "frame.png").exists()


def test_multiview_demo(tmp_path):
    out = _run("torch_multiview_demo.py", str(tmp_path))
    assert "composited 3x3 wall" in out and "plain torch" in out
    assert (tmp_path / "wall.png").exists()


def test_rotation_demo(tmp_path):
    out = _run("torch_rotation_demo.py", str(tmp_path))
    assert "wrote" in out
    assert (tmp_path / "first.png").exists() and (tmp_path / "last.png").exists()


def test_transcoding_demo():
    out = _run("torch_transcoding_demo.py")
    assert "transcoded" in out
    n = int(out.split("transcoded", 1)[1].split()[0])
    assert n >= 25


def test_motion_demo():
    out = _run("torch_motion_demo.py")
    assert "motion demo OK" in out


def test_real_codec_demo():
    _libav()
    out = _run("torch_real_codec_demo.py")
    assert "authored" in out and "H.264" in out
    assert "tone recovered" in out


def test_proto_interop_demo():
    out = _run("torch_proto_interop_demo.py")
    assert "proto interop demo OK" in out


def test_rtmp_server_demo():
    # the probe socket closes before the demo binds the port again; retry
    # once with a fresh port if another process took it in between
    for attempt in range(2):
        try:
            out = _run("torch_rtmp_server_demo.py", str(_free_port()))
            break
        except AssertionError as exc:
            if attempt == 0 and "Address already in use" in str(exc):
                continue
            raise
    assert "publisher connected" in out
    n = int(out.rsplit("server received", 1)[1].split()[0])
    assert n >= 25


def test_wall_demo(tmp_path):
    out = _run("torch_wall_demo.py", str(tmp_path / "wall.png"))
    assert "wrote" in out and "1600" in out
    assert (tmp_path / "wall.png").exists()


def test_live_station_demo():
    out = _run("torch_live_station_demo.py", timeout=360)
    assert "[station] ok" in out


def test_live_station_demo_real_codecs():
    """The station on real codecs: with no SWIFTVIDEO_FFMPEG override,
    avc/aac go through the in-process libav backend."""
    _libav()
    env = _demo_env()
    env.pop("SWIFTVIDEO_FFMPEG", None)
    out = _run("torch_live_station_demo.py", env=env, timeout=360)
    assert "[station] ok" in out
    assert "mixed video frames" in out
