"""Guards of the port: it never imports or loads JAX, triton or the JAX
package, the card is the default device and a cuda context needs one, and
the frame wrapper raises on inputs it does not take instead of falling
back."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch.media import PixelFormat
from swiftvideo_tpu_torch.ops import composite, frame, registry
from swiftvideo_tpu_torch.ops.uniforms import rect_uniforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ONE_TICK = r"""
import json, sys
import numpy as np
import swiftvideo_tpu_torch
import swiftvideo_tpu_torch.interop
import swiftvideo_tpu_torch.ops.matscale
import swiftvideo_tpu_torch.parallel
from swiftvideo_tpu_torch.core import Bus, EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu_torch.media import PixelFormat, create_picture_sample
from swiftvideo_tpu_torch.scene import Composition, Element, ElementState, Scene
from swiftvideo_tpu_torch.compose import Composer
from swiftvideo_tpu_torch.ops import make_compute_context

clock = StepClock(TimePoint(1000, 30000))
pictures = Bus(clock)
comp = Composition(name="c", canvas_size=(64, 36), scenes=(Scene(
    name="m", elements=(Element(name="e", initial_state=ElementState(
        size=(32.0, 18.0))),)),), initial_scene="m")
composer = Composer(clock, workspace_id="w", composition=comp,
                    audio_bus=Bus(clock), picture_bus=pictures,
                    compute_context=make_compute_context("cpu"))
frames = []
sub = pictures.subscribe(Tx(lambda s: (frames.append(s), EventBox.just(s))[1]
                            if s.asset_id() == "c" else EventBox.nothing(None)))
composer.bind("cam", "e")
src = create_picture_sample((64, 36), PixelFormat.y420p, asset_id="cam",
                            workspace_id="w")
src.planes()[0][:] = 200
pictures.append(EventBox.just(src))
clock.step()
composer.close()
print(json.dumps({"frames": len(frames),
                  "y": int(frames[-1].planes()[0][9, 16]),
                  "jax": any(m == "jax" or m.startswith("jax.")
                             for m in sys.modules),
                  "triton": any(m == "triton" or m.startswith("triton.")
                                for m in sys.modules),
                  "jax_package": sorted(
                      m for m in sys.modules if m == "swiftvideo_tpu"
                      or m.startswith("swiftvideo_tpu."))}))
"""

_BANNED = ("jax", "triton", "swiftvideo_tpu")


def _port_files():
    root = Path(REPO)
    return sorted((root / "swiftvideo_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]


def test_port_sources_import_no_jax_triton_or_jax_package():
    """An AST scan of every import in the port and in chip_smoke.py."""
    found = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in _BANNED]
    assert len(_port_files()) > 30
    assert found == []


def test_scan_covers_the_batch_paths():
    """The scan reaches the packages added after the first slice: the
    ladder's products, the resampler's device route and the wall."""
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"swiftvideo_tpu_torch/ops/matscale.py",
            "swiftvideo_tpu_torch/ops/fp32.py",
            "swiftvideo_tpu_torch/ops/resample.py",
            "swiftvideo_tpu_torch/parallel/__init__.py",
            "swiftvideo_tpu_torch/parallel/wall.py"} <= names


def test_port_never_imports_jax_or_triton():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _ONE_TICK], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["frames"] == 1 and abs(out["y"] - 200) <= 1
    assert out["jax"] is False
    assert out["triton"] is False
    assert out["jax_package"] == []


def test_cuda_context_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(registry.ComputeError, match="deviceNotAvailable"):
        registry.make_compute_context(torch.device("cuda"))
    with pytest.raises(registry.ComputeError, match="deviceNotAvailable"):
        registry.make_compute_context()
    assert registry.make_compute_context("cpu").kind == "cpu"


def _y420p(dtype=torch.uint8, w=32, h=16):
    return [torch.zeros(h, w, dtype=dtype),
            torch.zeros(h // 2, w // 2, dtype=dtype),
            torch.zeros(h // 2, w // 2, dtype=dtype)]


_UNI = rect_uniforms((32, 16), (64, 32), x=0, y=0, w=32, h=16)


@pytest.mark.parametrize("name,sources,kwargs,error", [
    ("int16 planes", [(_y420p(torch.int16), PixelFormat.y420p, _UNI)], {},
     TypeError),
    ("numpy planes", [([np.zeros((16, 32), np.uint8)] * 3, PixelFormat.y420p,
                       _UNI)], {}, TypeError),
    ("cpu planes, cuda device", [(_y420p(), PixelFormat.y420p, _UNI)],
     {"device": torch.device("cuda")}, ValueError),
    ("y422p target", [(_y420p(), PixelFormat.y420p, _UNI)],
     {"out_fmt": PixelFormat.y422p}, ValueError),
    ("planes do not fit format", [(_y420p()[:2], PixelFormat.y420p, _UNI)],
     {}, ValueError),
    ("packed 4:2:2 source", [([torch.zeros(16, 32, 2, dtype=torch.uint8)],
                              PixelFormat.yuvs, _UNI)], {}, ValueError),
    ("strided plane", [([torch.zeros(16, 64, dtype=torch.uint8)[:, ::2]]
                        + _y420p()[1:], PixelFormat.y420p, _UNI)], {},
     ValueError),
])
def test_frame_wrapper_rejects_instead_of_falling_back(name, sources, kwargs,
                                                       error):
    launches, calls = frame.launches, composite.calls
    with pytest.raises(error):
        frame.composite_frame_cuda((64, 32), sources, **kwargs)
    assert (frame.launches, composite.calls) == (launches, calls)


def test_frame_wrapper_takes_plain_version_for_cpu_tensors():
    launches, calls = frame.launches, composite.calls
    out = frame.composite_frame_cuda((64, 32), [(_y420p(), PixelFormat.y420p,
                                                 _UNI)], PixelFormat.nv21)
    assert frame.launches == launches and composite.calls == calls + 1
    assert [tuple(p.shape) for p in out] == [(32, 64), (16, 32, 2)]
    empty = frame.composite_frame_cuda((64, 32), [], device="cpu")
    assert int(empty[0].max()) == 0 and set(empty[1].unique().tolist()) == {128}


@pytest.mark.parametrize("out_fmt", [PixelFormat.RGBA, PixelFormat.BGRA],
                         ids=lambda f: f.value)
def test_frame_wrapper_takes_rgba_targets(out_fmt):
    """RGBA / BGRA targets are the kernel's too: CPU tensors take the plain
    version, a clear RGBA frame is (0, 0, 0, 255)."""
    launches, calls = frame.launches, composite.calls
    out = frame.composite_frame_cuda((64, 32), [(_y420p(), PixelFormat.y420p,
                                                 _UNI)], out_fmt)
    assert frame.launches == launches and composite.calls == calls + 1
    assert [tuple(p.shape) for p in out] == [(32, 64, 4)]
    empty = frame.composite_frame_cuda((64, 32), [], out_fmt, device="cpu")
    assert empty[0][..., 3].min() == 255 and int(empty[0][..., :3].max()) == 0
