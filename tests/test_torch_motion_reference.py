"""The benchmark's plain motion reference (``svbench/reference/motion.py``)
against the port and the JAX package.

The port's compute-registry path (``run_compute_kernel`` with
``me_fullsearch`` and ``me_fullsearch_pyramid``; CPU tensors take the
plain versions) must give the reference's map block for block: sizes from
64x48 to 160x96, heights that are not a multiple of the block, the
registry's window of 64 and the wrappers' window of 32, clamped windows at
every edge (shifts that reach past them), and frames built with exact
ties.  Where the height is a multiple of the block the reference also
equals the JAX package's device searches.  On the card, one 1920x1080
pair through the registry: K4 and the two-stage kernels against the
reference there.  Tolerance: none; the maps are equal byte for byte.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from svbench.reference import motion as ref_motion
from swiftvideo_tpu_torch.media import (BufferType, ImageBuffer,
                                        PictureSample, PixelFormat,
                                        create_picture_sample,
                                        planes_for_format)
from swiftvideo_tpu_torch.ops import motion, registry

KERNELS = ("me_fullsearch", "me_fullsearch_pyramid")
SEED = 2**31 + 18


@pytest.fixture(autouse=True)
def one_thread():
    """The searches here are thousands of small torch ops: one thread runs
    them fastest, and leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noise(w, h, seed, shift=(3, -5)):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w), np.uint8)
    cur = np.clip(ref.astype(int) + rng.integers(-6, 7, ref.shape), 0, 255)
    return np.roll(cur, shift, axis=(0, 1)).astype(np.uint8), ref


def _pan(w, h, seed, v=(-11, 7)):
    """A smooth texture with grain, moved by ``v`` pixels, and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 24, 0:w + 24].astype(np.float64)
    tex = ((np.sin(yy / 5.0 + rng.random() * 6) + np.cos(xx / 7.0)) * 50
           + 120 + rng.integers(0, 40, yy.shape))
    x0, y0 = 12, 12
    ref = tex[y0:y0 + h, x0:x0 + w]
    cur = tex[y0 + v[1]:y0 + v[1] + h, x0 + v[0]:x0 + v[0] + w]
    cur = cur + rng.integers(-2, 3, cur.shape)
    return (np.clip(cur, 0, 255).astype(np.uint8),
            np.clip(ref, 0, 255).astype(np.uint8))


def _edges(w, h, seed):
    """A shift of 20 pixels on each axis: the edge blocks' true match lies
    outside their clamped windows."""
    return _noise(w, h, seed, shift=(20, -20))


def _lattice(w, h, seed):
    """ref(x, y) = T[(x + y // 4) % 8, y % 16] and cur(x, y) = ref(x + 2,
    y - 8): (2, -8) and (-2, 8) tie exactly, score and cost, on the
    coarse grid and in the exhaustive search."""
    table = np.random.default_rng(seed).integers(0, 256, (8, 16))
    yy, xx = np.mgrid[0:h + 8, 0:w + 2]
    big = table[(xx + yy // 4) % 8, yy % 16].astype(np.uint8)
    return big[:h, 2:w + 2], big[8:h + 8, :w]


def _periodic(w, h, seed):
    """A frame periodic every 8 pixels on both axes, shifted by 4: the
    vectors (+-4, +-4) tie exactly."""
    table = np.random.default_rng(seed).integers(0, 256, (8, 8))
    yy, xx = np.mgrid[0:h + 4, 0:w + 4]
    big = table[yy % 8, xx % 8].astype(np.uint8)
    return big[:h, :w], big[4:h + 4, 4:w + 4]


CONTENT = {"noise": _noise, "pan": _pan, "edges": _edges,
           "lattice ties": _lattice, "periodic ties": _periodic}


def _sample(plane, device="cpu"):
    """A y420p sample whose luma plane is ``plane``."""
    h, w = plane.shape
    planes = [torch.as_tensor(plane, device=device)] + [
        torch.full((h // 2, w // 2), 128, dtype=torch.uint8, device=device)
        for _ in range(2)]
    img = ImageBuffer(pixel_format=PixelFormat.y420p,
                      buffer_type=(BufferType.gpu if planes[0].is_cuda
                                   else BufferType.cpu),
                      size=(w, h),
                      planes=tuple(planes_for_format(PixelFormat.y420p,
                                                     (w, h))),
                      buffers=tuple(planes))
    return PictureSample(img, "cam", "w")


def _registry(kernel, cur, ref, device="cpu"):
    h, w = cur.shape
    ctx = registry.make_compute_context(device)
    target = create_picture_sample((w // 16, h // 16), PixelFormat.RGBA,
                                   asset_id="mv", workspace_id="w")
    out = registry.run_compute_kernel(
        ctx, [_sample(cur, device), _sample(ref, device)], target,
        registry.default_compute_kernel_from_string(kernel))
    return out.planes()[0]


def _reference(kernel, cur, ref, search=64):
    return ref_motion.by_kernel(kernel, torch.as_tensor(cur),
                                torch.as_tensor(ref), 16, search, 2)


# (w, h): every content at the smallest size and at 88 rows (5 block rows
# and 8 rows no block owns); two each at 112 columns (the stride-1 coarse
# grid) and at the largest size
CASES = ([(s, c) for s in ((64, 48), (128, 88)) for c in sorted(CONTENT)]
         + [((112, 96), "noise"), ((112, 96), "edges"),
            ((160, 96), "pan"), ((160, 96), "lattice ties")])


@pytest.mark.parametrize("size,content", CASES,
                         ids=["x".join(map(str, s)) + "-" + c
                              for s, c in CASES])
@pytest.mark.parametrize("kernel", KERNELS)
def test_registry_path_equals_the_reference(kernel, size, content):
    cur, ref = CONTENT[content](*size, SEED + size[0] + size[1])
    launches = motion.launches
    got = _registry(kernel, cur, ref)
    assert motion.launches == launches  # CPU tensors: the plain versions
    want = _reference(kernel, cur, ref)
    assert got.shape == (size[1] // 16, size[0] // 16, 4)
    assert torch.equal(got, want), int((got != want).any(-1).sum())


@pytest.mark.parametrize("content", ["noise", "edges", "lattice ties"])
@pytest.mark.parametrize("size", [(64, 48), (128, 88), (160, 96)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", KERNELS)
def test_window_32_equals_the_reference(kernel, size, content):
    """The registry takes its default window of 64; the wrappers it calls
    take 32 as well."""
    cur, ref = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                CONTENT[content](*size, SEED + 7))
    if kernel == "me_fullsearch":
        got = motion.me_fullsearch(cur, ref, 16, 32, "sad")
    else:
        got = motion.me_fullsearch_pyramid(cur, ref, 16, 32, 2, "ssd")
    assert torch.equal(got, _reference(kernel, cur, ref, 32))


def test_ties_take_the_first_in_scan_order():
    """On the periodic frame the exhaustive search ties (+-4, +-4)
    exactly; the first strict minimum in (tx outer, ty inner) order is the
    smallest tx, then the smallest ty: the vector (4, 4) in the interior."""
    cur, ref = _periodic(96, 64, SEED)
    mv = _reference("me_fullsearch", cur, ref)
    lut = motion.tables(16, 64)[3]
    assert (mv[1:-1, 1:-1, 0] == int(lut[32 + 4])).all()
    assert (mv[1:-1, 1:-1, 2] == int(lut[32 + 4])).all()


@pytest.mark.parametrize("search", [32, 64])
@pytest.mark.parametrize("size", [(128, 96), (160, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_reference_equals_the_jax_package(size, search):
    from swiftvideo_tpu.ops import motion as jax_motion
    cur, ref = _pan(*size, SEED + search)
    full = jax_motion.me_fullsearch_device(cur, ref, 16, search, metric="sad")
    assert np.array_equal(
        _reference("me_fullsearch", cur, ref, search).numpy(),
        np.asarray(full))
    pyr = jax_motion.me_fullsearch_pyramid(cur, ref, 16, search, 2, "ssd")
    assert np.array_equal(
        _reference("me_fullsearch_pyramid", cur, ref, search).numpy(),
        np.asarray(pyr))


def test_reference_imports_nothing_of_either_package():
    path = Path(ref_motion.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "typing", "numpy", "torch"}
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernels_equal_the_reference_at_1080p(kernel):
    """One 1920x1080 pair (67 block rows; the last 8 rows only read)
    through the registry on the card: one K4 launch, or one coarse and
    one refine launch, and the reference's map."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    card = torch.device("cuda", torch.cuda.current_device())
    cur, ref = _pan(1920, 1080, SEED)
    before = dict(motion.route_launches)
    got = _registry(kernel, cur, ref, card)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in motion.route_launches.items()
           if n != before[k]}
    assert ran == ({motion.KERNELS["sad"]: 1} if kernel == "me_fullsearch"
                   else {motion.COARSE_KERNEL: 1, motion.REFINE_KERNEL: 1})
    want = ref_motion.by_kernel(kernel, torch.as_tensor(cur, device=card),
                                torch.as_tensor(ref, device=card), 16, 64, 2)
    assert got.is_cuda and got.shape == (67, 120, 4)
    assert torch.equal(got, want), int((got != want).any(-1).sum())
