"""The port's kernels on an NVIDIA card: the frame kernel (yuv and RGBA /
BGRA targets) and the motion search (SAD and SSD) against their plain torch
versions on the same CUDA tensors, the two-stage motion search (the
coarse kernel on the stride-2 grid, K5's coarse mode on the stride-1 grid,
and the refine kernel) against its plain version, and the audio
folds against the host loop; the wall's audio mix kernel against its
plain version (bit-exact where every sum is exact) and its in-order
float32 contract (bit-exact for every gain), at the wall's shape and at
sample counts that leave a tail; the batch paths: the ladder's products (<= 1 LSB against the plain
composite, and raising under the TF32 switches), the batched fold (exact),
the device resampler (< 1e-4 against the host route), the SRC stage's
bookkeeping and the audio ingest's 64 stages against the benchmark's plain
reference (counts and pts exact, samples within 1 LSB); the ladder's rungs (one frame-kernel launch each, 0 LSB
against the plain composite; the products, kept as a comparison, within 1
LSB and raising under the TF32 switches), the frame kernel's cell launch
on the row kernel and, for a rotated cell, the tile kernel (0 LSB against
the per-cell plain fold, one FrameParams per 32 cells, the row kernel's
unchained ones two to a launch, counted by the profiler; the wall's and
the batch scale's shapes; onto a canvas of cell rows and columns, chained
bands included; a 16-frame 1080p batch to each rung of the HLS ladder on
the row kernel and on the tile kernel, and the five-rung ladder, and a
tiny one with an odd chroma cell, as one call of the ladder's kept plan,
two rungs a launch), its kept plan
(new addresses and new uniforms, 0 LSB; the words the C entry launched
against the plan's words on the host) and the mixing
wall's default and per-cell paths through it (0 LSB); the upload
barrier's copies, many in flight at once (exact).  Marked ``cuda``; they skip where there is no card.  Run them on the
card with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerance: 0 LSB for pixels (the frame kernels are bit-exact against the
plain version), exact for motion vectors and audio.  The frame cases cover
every target the kernel writes (packed 4:2:2 through the registry), both of the kernels' map paths (the row side once per run for axis-aligned
sources, every map per pixel for rotated ones), downscales and upscales,
ragged runs, stacks longer than one launch and chained targets.  Imports
the port and the benchmark's plain references."""

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch.core import TimePoint, spans
from swiftvideo_tpu_torch.media import PixelFormat as PF
from swiftvideo_tpu_torch.media.audio import AudioFormat, AudioSample
from swiftvideo_tpu_torch.mix.src_audio import AudioSampleRateConversion
from swiftvideo_tpu_torch.ops import (audio, barriers, composite, frame,
                                      matscale, motion, registry, resample)
from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms, rect_uniforms
from swiftvideo_tpu_torch.parallel import MixingWall
from wall_audio_cases import EXACT_KINDS, case as wall_audio_case

pytestmark = pytest.mark.cuda

TOL = 0
CAP = frame.CAPACITY
FMTS = [PF.y420p, PF.y422p, PF.y444p, PF.nv12, PF.nv21, PF.RGBA, PF.BGRA]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


def _planes(rng, fmt, w, h, device):
    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, np.int64)
                                .astype(np.uint8)).to(device)
    if fmt == PF.y420p:
        return [u8(h, w), u8(h // 2, w // 2), u8(h // 2, w // 2)]
    if fmt in (PF.nv12, PF.nv21):
        return [u8(h, w), u8(h // 2, w // 2, 2)]
    return [u8(h, w, 4)]


def _scene(rng, device, w, h):
    """Cameras 2:1 into quadrants, a rotated nv12 picture-in-picture with
    border and fill, a fractional-scale nv21 source, a rotated BGRA logo
    and an RGBA lower third with an alpha ramp."""
    srcs = [(_planes(rng, PF.y420p, w, h, device), PF.y420p, rect_uniforms(
        (w, h), (w, h), x=(s % 2) * w / 2, y=(s // 2) * h / 2, w=w / 2,
        h=h / 2, opacity=0.9)) for s in range(4)]
    srcs += [
        (_planes(rng, PF.nv12, w // 2, h // 2, device), PF.nv12, rect_uniforms(
            (w // 2, h // 2), (w, h), x=w / 4, y=h / 4, w=w / 3, h=h / 3,
            rotation=0.4, opacity=0.7, fill_color=(0.9, 0.2, 0.1, 0.6),
            border=(w / 4 - 6, h / 4 - 6, w / 3 + 12, h / 3 + 12))),
        (_planes(rng, PF.nv21, w, h, device), PF.nv21, rect_uniforms(
            (w, h), (w, h), x=10.25, y=5.5, w=w * 0.4, h=h * 0.37,
            opacity=0.8)),
        (_planes(rng, PF.BGRA, w // 4, h // 4, device), PF.BGRA,
         rect_uniforms((w // 4, h // 4), (w, h), x=w * 0.6, y=h * 0.1,
                       w=w / 4, h=h * 0.375, rotation=-0.2,
                       fill_color=(0.1, 0.8, 0.3, 0.5),
                       border=(w * 0.6 - 4, h * 0.1 - 4, w / 4 + 8,
                               h * 0.375 + 8))),
    ]
    lower = _planes(rng, PF.RGBA, w, h // 5, device)
    lower[0][..., 3] = torch.linspace(0, 255, w, device=device).to(
        torch.uint8)[None, :]
    srcs.append((lower, PF.RGBA, rect_uniforms(
        (w, h // 5), (w, h), x=0, y=h - h // 5 - 20, w=w, h=h // 5)))
    return srcs


def _assert_matches_plain(card, size, srcs, out_fmt, launches_per_call=1,
                          target=None):
    launches = frame.launches
    got = frame.composite_frame_cuda(size, srcs, out_fmt, target=target)
    assert frame.launches == launches + launches_per_call
    ref = composite.composite_stack_torch(out_fmt, size, srcs, card,
                                          target=target)
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape
        assert int((g.int() - r.int()).abs().max()) <= TOL


# 642x362 and 1918x1078: widths that are not a multiple of a thread's run
# of 4 pixels, and rows that are not word-aligned
@pytest.mark.parametrize("size", [(320, 180), (642, 362), (1918, 1078),
                                  (1920, 1080)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("out_fmt", FMTS, ids=lambda f: f.value)
def test_kernel_matches_plain_on_card(card, size, out_fmt):
    _assert_matches_plain(card, size, _scene(np.random.default_rng(1), card,
                                             *size), out_fmt)


@pytest.mark.parametrize("out_fmt", [PF.nv21, PF.BGRA, PF.y420p, PF.RGBA,
                                     PF.y422p, PF.y444p],
                         ids=lambda f: f.value)
def test_kernel_chained_target_on_card(card, out_fmt):
    size = (320, 180)
    srcs = _scene(np.random.default_rng(2), card, *size)
    base = composite.composite_stack_torch(out_fmt, size, srcs[:3], card)
    _assert_matches_plain(card, size, srcs[3:], out_fmt, target=base)


@pytest.mark.parametrize("out_fmt", FMTS, ids=lambda f: f.value)
def test_kernel_stack_longer_than_capacity_on_card(card, out_fmt):
    """CAPACITY + 3 mixed sources run as two launches, the second chained."""
    rng = np.random.default_rng(5)
    srcs = []
    for s in range(CAP + 3):
        fmt = (PF.y420p, PF.nv12, PF.BGRA, PF.RGBA)[s % 4]
        extra = {}
        if s % 4 == 2:
            extra = dict(rotation=0.3 + 0.05 * s)
        if s % 4 == 3:
            extra = dict(fill_color=(0.2, 0.5, 0.7, 0.6),
                         border=(s * 9.0 - 3, s * 5.0 - 2, 106, 70))
        srcs.append((_planes(rng, fmt, 128, 72, card), fmt, rect_uniforms(
            (128, 72), (320, 180), x=s * 9.0, y=s * 5.0, w=100, h=64.5,
            opacity=0.55 + 0.01 * s, **extra)))
    _assert_matches_plain(card, (320, 180), srcs, out_fmt,
                          launches_per_call=2)


@pytest.mark.parametrize("out_fmt", FMTS, ids=lambda f: f.value)
def test_kernel_4to1_downscale_on_card(card, out_fmt):
    """A 3840x2160 camera into a 960x540 box: a tile's taps spread over
    a footprint of 16 texels per output pixel."""
    src = _planes(np.random.default_rng(6), PF.y420p, 3840, 2160, card)
    srcs = [(src, PF.y420p, rect_uniforms((3840, 2160), (1920, 1080), x=480,
                                          y=270, w=960, h=540))]
    _assert_matches_plain(card, (1920, 1080), srcs, out_fmt)


@pytest.mark.parametrize("out_fmt", FMTS, ids=lambda f: f.value)
def test_kernel_upscale_on_card(card, out_fmt):
    """A 960x540 camera upscaled 2x to the whole 1920x1080 canvas and a
    1:1 RGBA logo over it: a tile's pixels re-read the same texels."""
    rng = np.random.default_rng(8)
    logo = _planes(rng, PF.RGBA, 320, 96, card)
    srcs = [(_planes(rng, PF.y420p, 960, 540, card), PF.y420p,
             rect_uniforms((960, 540), (1920, 1080), x=0, y=0, w=1920,
                           h=1080)),
            (logo, PF.RGBA, rect_uniforms((320, 96), (1920, 1080), x=64.25,
                                          y=40.5, w=320, h=96, opacity=0.8))]
    _assert_matches_plain(card, (1920, 1080), srcs, out_fmt)


@pytest.mark.parametrize("out_fmt", [PF.y420p, PF.RGBA], ids=lambda f: f.value)
def test_kernel_rotated_source_with_axis_aligned_ones_on_card(card, out_fmt):
    """Axis-aligned cameras upscaled 1.5x and a rotated overlay in one
    launch, the overlay crossing tiles that fold the cameras."""
    rng = np.random.default_rng(7)
    w, h = 640, 360
    srcs = [(_planes(rng, PF.y420p, w // 3, h // 3, card), PF.y420p,
             rect_uniforms((w // 3, h // 3), (w, h), x=(s % 2) * w / 2,
                           y=(s // 2) * h / 2, w=w / 2, h=h / 2, opacity=0.9))
            for s in range(4)]
    srcs.insert(2, (_planes(rng, PF.RGBA, 200, 120, card), PF.RGBA,
                    rect_uniforms((200, 120), (w, h), x=220, y=120, w=200,
                                  h=120, rotation=0.6, opacity=0.8)))
    _assert_matches_plain(card, (w, h), srcs, out_fmt)


def test_rgba_kernel_config1_on_card(card):
    """A 1280x720 y420p picture scaled into a 640x360 RGBA canvas."""
    src = _planes(np.random.default_rng(4), PF.y420p, 1280, 720, card)
    srcs = [(src, PF.y420p, rect_uniforms((1280, 720), (640, 360), x=0, y=0,
                                          w=640, h=360))]
    got = frame.composite_frame_cuda((640, 360), srcs, PF.RGBA)
    ref = composite.composite_stack_torch(PF.RGBA, (640, 360), srcs, card)
    assert got[0].shape == (360, 640, 4)
    assert int((got[0].int() - ref[0].int()).abs().max()) <= TOL


@pytest.mark.parametrize("out_fmt", [PF.yuvs, PF.zvuy], ids=lambda f: f.value)
def test_registry_packed_target_on_card(card, out_fmt):
    """A packed 4:2:2 target through the registry: unpacked, one launch of
    the frame kernel as y422p, packed again; equal to the plain version
    (which the card path never calls), on a ragged 642x362 canvas."""
    size = (642, 362)
    rng = np.random.default_rng(9)
    srcs = _scene(rng, card, *size)
    base = torch.from_numpy(rng.integers(0, 256, (362, 642, 2), np.int64)
                            .astype(np.uint8)).to(card)
    ctx = registry.make_compute_context(card)
    launches, calls = frame.launches, composite.calls
    for target in (None, [base]):
        got = registry.composite_frame(ctx, out_fmt, size, srcs, target=target)
        ref = composite.composite_stack_torch(out_fmt, size, srcs, card,
                                              target=target)
        torch.cuda.synchronize()
        assert got[0].is_cuda and got[0].shape == ref[0].shape == (362, 642, 2)
        assert int((got[0].int() - ref[0].int()).abs().max()) <= TOL
    assert (frame.launches, composite.calls) == (launches + 2, calls + 2)


def _frames(rng, h, w, device):
    ref = rng.integers(0, 255, (h, w), np.int64).astype(np.uint8)
    cur = np.clip(ref.astype(int) + rng.integers(-12, 12, ref.shape), 0,
                  255).astype(np.uint8)
    return (torch.from_numpy(cur).to(device), torch.from_numpy(ref).to(device))


def _tie_frames(kind, h, w, device):
    """Inputs where many candidates tie: a flat frame; a frame periodic
    every 4 or 8 pixels both ways against itself shifted by half a period
    (the vectors (+-p/2, +-p/2) tie exactly in score and cost, so the scan
    order decides); an all-255 frame (the largest exact sums)."""
    rng = np.random.default_rng(len(kind) + h + w)
    if kind == "flat":
        ref = np.full((h, w), 77, np.uint8)
        cur = ref
    elif kind.startswith("period"):
        p = int(kind[len("period"):])
        tile = rng.integers(0, 256, (p, p), np.int64).astype(np.uint8)
        ref = np.tile(tile, (h // p + 1, w // p + 1))[:h, :w]
        cur = np.roll(ref, (p // 2, p // 2), axis=(0, 1))
    else:
        ref = np.full((h, w), 255, np.uint8)
        cur = ref
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cur, ref))


def _kernel_equals_plain(cur, ref, search, metric):
    h, w = cur.shape
    launches = motion.launches
    routed = motion.route_launches[motion.KERNELS[metric]]
    got = motion.me_fullsearch(cur, ref, 16, search, metric)
    assert motion.launches == launches + 1
    assert motion.route_launches[motion.KERNELS[metric]] == routed + 1
    want = motion.me_fullsearch_torch(cur, ref, 16, search, metric)
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == (h // 16, w // 16, 4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("metric", motion.METRICS)
@pytest.mark.parametrize("geom", [(96, 128, 64), (120, 128, 32), (48, 80, 64),
                                  (64, 64, 16), (1080, 1920, 64),
                                  (2160, 3840, 64), (1080, 1918, 64),
                                  (360, 640, 128), (130, 70, 100),
                                  (96, 128, 48), (1080, 1920, 48)],
                         ids=lambda g: "x".join(map(str, g)))
def test_motion_kernel_matches_plain_on_card(card, geom, metric):
    """Clamped windows at every edge; 4K; a width that is not a multiple
    of 16 (rows not 4-byte aligned); searches of several staged chunks;
    search 48, where the u8 emit's float32 table differs from the float64
    oracles' (both sides read the one table)."""
    h, w, search = geom
    cur, ref = _frames(np.random.default_rng(h + w + search), h, w, card)
    _kernel_equals_plain(cur, ref, search, metric)


@pytest.mark.parametrize("metric", motion.METRICS)
@pytest.mark.parametrize("kind", ["flat", "period4", "period8", "all255"])
def test_motion_kernel_ties_match_plain_on_card(card, kind, metric):
    cur, ref = _tie_frames(kind, 272, 480, card)
    _kernel_equals_plain(cur, ref, 64, metric)


@pytest.mark.parametrize("metric", motion.METRICS)
@pytest.mark.parametrize("geom", [(96, 128, 64), (144, 192, 62), (96, 112, 64),
                                  (80, 96, 30), (96, 192, 60), (160, 224, 128),
                                  (1080, 1920, 64), (2160, 3840, 64),
                                  (2160, 3840, 62)],
                         ids=lambda g: "x".join(map(str, g)))
def test_pyramid_kernels_match_plain_on_card(card, geom, metric):
    """The two-stage search: the coarse stage at both strides against
    ``me_coarse_torch`` (search 62 puts the dx grid on odd tx at the left
    edge, 60 shifts the left groups' bands by 2 bytes, 128 takes three
    chunks a row; 112 columns take the stride-1 grid), the refine kernel
    against ``refine_torch`` around the same coarse vectors, and the whole
    pyramid against its plain version in exactly two launches: the
    stride's coarse kernel and the refine."""
    h, w, search = geom
    cur, ref = _frames(np.random.default_rng(h * w + search), h, w, card)
    _coarse_and_refine_equal_plain(cur, ref, search)
    stride = motion.coarse_stride(w)
    before = dict(motion.route_launches)
    got = motion.me_fullsearch_pyramid(cur, ref, 16, search, 2, metric)
    assert {k: n - before[k] for k, n in motion.route_launches.items()
            if n != before[k]} == {motion.COARSE_KERNELS[stride]: 1,
                                   motion.REFINE_KERNEL: 1}
    assert torch.equal(got, motion.me_fullsearch_pyramid_torch(
        cur, ref, 16, search, 2, metric))


def _lattice_frames(h, w, device):
    """ref(x, y) = T[(x + y // 4) % 8, y % 16] and cur(x, y) = ref(x + 2,
    y - 8): the vectors (2, -8) and (-2, 8) tie exactly (score and cost),
    and the one the two-stage minimum picks lies in the coarse kernel's
    second M tile (grid row 16) while its first tile holds the other."""
    table = np.random.default_rng(5).integers(0, 256, (8, 16))
    yy, xx = np.mgrid[0:h + 8, 0:w + 2]
    big = table[(xx + yy // 4) % 8, yy % 16].astype(np.uint8)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (big[:h, 2:w + 2], big[8:h + 8, :w]))


def _coarse_and_refine_equal_plain(cur, ref, search):
    w = cur.shape[1]
    for stride in (1, 2):
        assert torch.equal(motion.me_coarse(cur, ref, 16, search, stride),
                           motion.me_coarse_torch(cur, ref, 16, search, stride))
    raw = motion.me_coarse(cur, ref, 16, search, motion.coarse_stride(w))
    for refine in (1, 2):
        for metric in motion.METRICS:
            assert torch.equal(
                motion.me_refine(cur, ref, raw, 16, search, refine, metric),
                motion.refine_torch(cur, ref, raw, 16, search, refine, metric))


@pytest.mark.parametrize("kind", ["lattice", "flat", "period4", "period8"])
@pytest.mark.parametrize("search", [64, 62, 60])
def test_pyramid_stages_tie_order_on_card(card, kind, search):
    """Both stages on frames whose candidates tie exactly: the first of
    the (score, tx, inner, ty) and (score, s) orders must win whichever
    warp or lane holds it."""
    cur, ref = (_lattice_frames(96, 192, card) if kind == "lattice"
                else _tie_frames(kind, 96, 192, card))
    _coarse_and_refine_equal_plain(cur, ref, search)


@pytest.mark.parametrize("offset", [1, 3, 13])
def test_pyramid_stages_on_offset_buffers_on_card(card, offset):
    """Frames that are contiguous views starting ``offset`` bytes into
    their storage: the stages load whole 16-byte granules clamped into the
    frame's buffer, so the first and last granules straddle its ends."""
    h, w = 96, 192
    cur0, ref0 = _frames(np.random.default_rng(offset), h, w, card)
    views = []
    for plane, extra in ((cur0, offset), (ref0, offset + 5)):
        buf = torch.zeros(h * w + 32, dtype=torch.uint8, device=card)
        buf[extra:extra + h * w] = plane.reshape(-1)
        views.append(buf[extra:extra + h * w].view(h, w))
    assert all(v.is_contiguous() and v.data_ptr() % 16 for v in views)
    _coarse_and_refine_equal_plain(*views, 60)


@pytest.mark.parametrize("metric", motion.METRICS)
def test_motion_kernel_recovers_a_shift_on_card(card, metric):
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 255, (256, 256), np.int64).astype(np.uint8)
    cur = np.roll(ref, (5, -7), axis=(0, 1))
    out = motion.me_fullsearch(torch.from_numpy(cur).to(card),
                               torch.from_numpy(ref).to(card), 16, 64,
                               metric).cpu().numpy()
    inner = out[2:-2, 2:-2]
    assert np.all(inner[..., 0] == round((-7 / 32 * 0.5 + 0.5) * 255))
    assert np.all(inner[..., 2] == round((5 / 32 * 0.5 + 0.5) * 255))


def test_audio_folds_equal_host_on_card(card):
    rng = np.random.default_rng(3)
    n_src, n = 64, 960 * 2
    srcs = rng.integers(-32768, 32768, (n_src, n), np.int64).astype(np.int16)
    gains = rng.uniform(0.0, 1.5, (n_src, 2)).astype(np.float32)
    host = np.zeros(n, np.int16)
    for k in range(n_src):
        audio.apply_mix_s16(srcs[k], gains[k], host)
    out = audio.mix_s16_device(torch.from_numpy(srcs).to(card), gains)
    assert np.array_equal(out.cpu().numpy(), host)
    starts = np.full(n_src, 7)
    ends = np.full(n_src, n - 3)
    win = np.zeros_like(srcs)
    win[:, 7:n - 3] = srcs[:, :n - 10]
    host_w = np.zeros(n, np.int16)
    for k in range(n_src):
        audio.apply_mix_s16(srcs[k, :n - 10], gains[k], host_w,
                            backing_start=7)
    out_w = audio.mix_s16_device_windowed(torch.from_numpy(win).to(card),
                                          gains, starts, ends)
    assert np.array_equal(out_w.cpu().numpy(), host_w)


# --- the batch paths: ladder, resampler, wall (torch ops around K1) -------

def _y420p(rng, w, h, device, n=None):
    lead = () if n is None else (n,)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, lead + shape, np.int64)
                                .astype(np.uint8)).to(device)
    return [u8(h, w), u8(h // 2, w // 2), u8(h // 2, w // 2)]


def _plain_scale(card, planes, in_size, out_size):
    return composite.composite_stack_torch(
        PF.y420p, out_size, [(planes, PF.y420p,
                              identity_uniforms(in_size, out_size))], card)


@pytest.mark.parametrize("rung", [(1280, 720), (854, 480), (640, 360)],
                         ids=lambda r: f"{r[0]}x{r[1]}")
def test_ladder_rung_within_one_lsb_of_plain_on_card(card, rung):
    """The rung is one frame-kernel launch, bit for bit the plain composite;
    the products, a comparison only, stay within 1 LSB of it."""
    planes = _y420p(np.random.default_rng(rung[0]), 1920, 1080, card)
    plan = matscale.plan_scale(identity_uniforms((1920, 1080), rung), rung,
                               (1080, 1920))
    launches, products = frame.launches, matscale.calls
    got = matscale.scale_y420p(planes, plan)
    assert (frame.launches, matscale.calls) == (launches + 1, products)
    want = _plain_scale(card, planes, (1920, 1080), rung)
    dense = matscale.products(*planes, plan)
    for g, w, d in zip(got, want, dense):
        assert g.is_cuda and g.dtype == torch.uint8 and g.shape == w.shape
        assert torch.equal(g, w)
        assert int((d.int() - w.int()).abs().max()) <= 1


@pytest.mark.parametrize("switch", ["allow_tf32", "precision high"])
def test_ladder_and_resampler_raise_under_tf32_on_card(card, switch):
    """The TF32 switches would put the products on TF32 and lose the 1 LSB
    contract: the ladder's products and the resampler raise instead.  The
    ladder's own route, the frame kernel, does not read them."""
    planes = _y420p(np.random.default_rng(0), 1920, 1080, card)
    plan = matscale.plan_scale(identity_uniforms((1920, 1080), (640, 360)),
                               (640, 360), (1080, 1920))
    rs = resample.PolyphaseResampler(44100, 48000, 2, use_device=True,
                                     device=card)
    before = torch.get_float32_matmul_precision()
    try:
        if switch == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            matscale.products(*planes, plan)
        with pytest.raises(RuntimeError, match="full float32"):
            rs.process(np.zeros((2, 4096), np.float32))
        got_tf32 = matscale.scale_y420p(planes, plan)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision(before)
    want = _plain_scale(card, planes, (1920, 1080), (640, 360))
    assert all(torch.equal(g, w) for g, w in zip(got_tf32, want))
    dense = matscale.products(*planes, plan)
    assert max(int((g.int() - w.int()).abs().max())
               for g, w in zip(dense, want)) <= 1


def test_batched_fold_equals_host_on_card(card):
    rng = np.random.default_rng(5)
    b, s, n = 8, 6, 960 * 2
    srcs = rng.integers(-32768, 32768, (b, s, n), np.int64).astype(np.int16)
    gains = rng.uniform(0.0, 1.5, (b, s, 2)).astype(np.float32)
    base = rng.integers(-32768, 32768, (b, n), np.int64).astype(np.int16)
    out = audio.mix_s16_device_batched(torch.from_numpy(srcs).to(card), gains,
                                       base=torch.from_numpy(base).to(card))
    assert out.is_cuda
    out = out.cpu().numpy()
    for k in range(b):
        host = base[k].copy()
        for j in range(s):
            audio.apply_mix_s16(srcs[k, j], gains[k, j], host)
        assert np.array_equal(out[k], host)


def test_device_resampler_matches_host_on_card(card):
    """Tolerance < 1e-4: the JAX package's bound between its routes."""
    rng = np.random.default_rng(6)
    dev = resample.PolyphaseResampler(44100, 48000, 8, use_device=True,
                                      device=card)
    host = resample.PolyphaseResampler(44100, 48000, 8)
    for n in (44100, 17, 4096, 1):
        x = rng.standard_normal((8, n)).astype(np.float32)
        a, b = dev.process(x), host.process(x)
        assert a.shape == b.shape
        if a.size:
            assert np.abs(a - b).max() < 1e-4


def test_src_device_route_bookkeeping_on_card(card):
    rng = np.random.default_rng(7)
    stages = [AudioSampleRateConversion(48000, 2, AudioFormat.s16i,
                                        use_device=flag) for flag in (True,
                                                                      False)]
    outs = ([], [])
    pts = TimePoint(0, 44100)
    for n in (1024, 333, 4410, 7):
        pcm = rng.integers(-20000, 20000, 2 * n, np.int64).astype(np.int16)
        for stage, out in zip(stages, outs):
            r = stage(AudioSample(buffers=(pcm,), frequency=44100, channels=2,
                                  format=AudioFormat.s16i, sample_count=n,
                                  pts_value=pts, id_asset="mic",
                                  id_workspace="w"))
            out += [r.value()] if r.value() is not None else []
        pts = pts + TimePoint(n, 44100)
    for stage, out in zip(stages, outs):
        out += stage.flush()
    assert stages[0].device.type == "cuda"
    assert len(outs[0]) == len(outs[1]) > 2
    for a, b in zip(*outs):
        assert a.number_samples() == b.number_samples()
        assert (a.pts().value, a.pts().scale) == (b.pts().value, b.pts().scale)
        assert np.abs(a.data()[0].astype(int) - b.data()[0].astype(int)).max() <= 1


def test_src_stages_of_the_ingest_against_the_reference_on_card(card):
    """The audio ingest's shape: 64 stereo publishers, 20 f32p frames of
    1024 samples each at 44.1 kHz, every stream through its own SRC stage
    on the card route to 48 kHz s16i.  Every emitted sample's count and pts
    exact against the benchmark's plain reference, its samples within 1
    LSB (the card's GEMM and the reference sum the same 24 float32
    products in different orders)."""
    from svbench.reference import resample as ref
    d = ref.design(44100, 48000)
    rng = np.random.default_rng(64)
    frames, size = 20, 1024
    for s in range(64):
        stage = AudioSampleRateConversion(48000, 2, AudioFormat.s16i,
                                          use_device=True, device=card)
        t = np.arange(frames * size) / 44100.0
        x = (0.18 * np.sin(2 * np.pi * rng.uniform(50, 18000, (2, 1)) * t)
             + 0.01 * rng.standard_normal((2, frames * size)))
        x[:, rng.integers(0, x.shape[1], 4)] = 1.3
        x = x.astype(np.float32)
        pts0 = int(rng.integers(0, 2**31))
        pts = ref.first_pts(pts0, 44100, 48000)
        xd = torch.from_numpy(x).to(card)
        for k in range(frames):
            got = stage(AudioSample(
                buffers=tuple(np.ascontiguousarray(
                    x[:, k * size:(k + 1) * size])),
                frequency=44100, channels=2, format=AudioFormat.f32p,
                sample_count=size, pts_value=TimePoint(pts0 + k * size,
                                                       44100),
                id_asset=f"publisher{s}", id_workspace="ingest")).value()
            n0, n1 = ref.emitted(d, k * size), ref.emitted(d, (k + 1) * size)
            assert got.number_samples() == n1 - n0 in (960, 1120)
            assert (got.pts().value, got.pts().scale) == (pts, 48000)
            want = ref.to_s16(ref.outputs(d, xd, n0, n1)).cpu().numpy()
            have = got.data()[0]
            assert have.shape == want.shape
            assert np.abs(have.astype(np.int32) - want).max() <= 1
            pts += n1 - n0
    assert stage._resampler.device.type == "cuda"


def _cell_unis(n, stream, cell, rng):
    """Per-cell uniforms: identity, half opacity, an aspect inset with a
    fill colour and a border, an offset rect overhanging the cell's top and
    bottom, one overhanging its right edge; cells 0 and 1 take the second
    and the fourth."""
    tw, th = cell
    kinds = [
        lambda: identity_uniforms(stream, cell),
        lambda: identity_uniforms(stream, cell, opacity=0.5),
        lambda: rect_uniforms(stream, cell, x=1.25, y=2.25, w=tw - 2.5,
                              h=th - 4.5, fill_color=(0.9, 0.2, 0.1, 0.6),
                              border=(0.25, 0.25, tw - 0.5, th - 0.5)),
        lambda: rect_uniforms(stream, cell, x=3.25, y=-1.75, w=tw * 0.75,
                              h=th * 1.25, opacity=0.8),
        lambda: rect_uniforms(stream, cell, x=tw * 0.5 + 0.25, y=0.25,
                              w=tw * 0.75, h=th * 0.5, opacity=0.9),
    ]
    picks = [1, 3] + [int(k) for k in rng.integers(0, len(kinds), n)]
    return np.stack([kinds[k]().pack() for k in picks[:n]])


def _launches_a_call(fn, made, calls=20, tries=3):
    """Whether the card ran ``made`` frame-kernel launches a call of fn:
    torch.profiler's CUDA kernel events named ``frame_composite_kernel`` or
    a longer name over ``calls`` calls, after a warm call, lie in ((made -
    1) calls, made calls].  A profile can lose launches (PERF.md), so it is
    taken again, ``tries`` times at most, as chip_smoke.py takes its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and frame.YUV_KERNEL in e.name))
        if (made - 1) * calls < counts[-1] <= made * calls:
            return True
    print(f"frame-kernel launches seen in {calls} calls: {counts}")
    return False


def _rotated_unis(n, stream, cell, rng, at):
    """``_cell_unis`` with cell ``at`` rotated (off the row kernel)."""
    unis = _cell_unis(n, stream, cell, rng)
    tw, th = cell
    unis[at] = rect_uniforms(stream, cell, x=tw * 0.2 + 0.25,
                             y=th * 0.2 + 0.25, w=tw * 0.6, h=th * 0.6,
                             rotation=0.3, opacity=0.9).pack()
    return unis


# (frames, stream size, cell, grid or None, uniforms, route, (kernel
# launches, of them the row kernel's) a call): "cells" is
# composite_cells_cuda, "scale" matscale.scale_y420p_batch
_CELL_CASES = {
    **{f"{c[0]}x{c[1]}-{n}": (n, (192, 108), c, None, "per-cell", "cells",
                              (1, 1))
       for n in (1, 5, 40, 64) for c in ((240, 136), (34, 18))},
    "wall 64x1080p on 8x8": (64, (1920, 1080), (240, 136), (8, 8),
                             "identity", "cells", (1, 1)),
    "scale 40x192x108 to 48x36": (40, (192, 108), (48, 36), None, "identity",
                                  "scale", (1, 1)),
    "scale 4x1080p to 640x360": (4, (1920, 1080), (640, 360), None,
                                 "identity", "scale", (1, 1)),
    "ragged 34x18 on 5x2": (7, (64, 36), (34, 18), (5, 2), "per-cell",
                            "cells", (1, 1)),
    "rotated cell 3 of 40": (40, (192, 108), (240, 136), None, "rotated",
                             "cells", (2, 1)),
    # the widest rows a stage holds: luma 4064 and chroma 2032 bytes (its
    # four chroma slots fill the stage); a chroma row of 2033 or 2040
    # bytes does not fit, and those launches take the tile kernel
    **{f"{w}-wide frames": (3, (w, 72), (240, 136), None, "per-cell", "cells",
                            (1, int(w <= 4064))) for w in (4064, 4066, 4080)},
}


@pytest.mark.parametrize("case", list(_CELL_CASES), ids=str)
def test_cell_launch_matches_per_cell_plain_fold_on_card(card, case):
    """Each cell bit for bit the plain composite of its source alone onto a
    cleared cell (with opacity, fill, offset and overhanging cells; the
    wall's own shapes; the batch scale's; frames at and past the widest
    rows the row kernel stages), one FrameParams per 32 cells; the C
    call's counts say which kernel took each launch: the row kernel where
    every source of the launch is axis-aligned and its rows fit a stage
    (both of a 40- or 64-cell layout in one launch of it), the tile kernel
    for the launch that holds a rotated cell or rows too wide; the
    profiler counts the same launches."""
    n, stream, cell, grid, kind, route, want = _CELL_CASES[case]
    rng = np.random.default_rng(n)
    ys, us, vs = _y420p(rng, *stream, card, n)
    unis = (_cell_unis(n, stream, cell, rng) if kind == "per-cell"
            else _rotated_unis(n, stream, cell, rng, 3) if kind == "rotated"
            else np.stack([identity_uniforms(stream, cell).pack()] * n))
    launches, calls = frame.launches, composite.calls

    def call():
        if route == "scale":
            plan = matscale.plan_scale(identity_uniforms(stream, cell), cell,
                                       stream[::-1])
            return [t.reshape(-1, t.shape[-1]) for t in
                    matscale.scale_y420p_batch(ys, us, vs, plan)]
        return frame.composite_cells_cuda(cell, [ys, us, vs], PF.y420p, unis,
                                          grid=grid)
    spans.start()
    try:
        got = call()
        torch.cuda.synchronize()
    finally:
        rec = spans.stop()
    assert len(frame.cell_plan(cell, grid, [ys, us, vs], PF.y420p,
                               unis).words) == -(-n // CAP)
    assert frame.launches == launches + want[0]
    assert composite.calls == calls
    assert (rec.counters.get("frame.cell_launches"),
            rec.counters.get("frame.cell_row_launches", 0)) == want
    assert _launches_a_call(call, want[0])
    want = composite.composite_cells_torch(
        cell, [([ys[i], us[i], vs[i]], PF.y420p, unis[i]) for i in range(n)],
        card, grid=grid)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, w)


# the HLS ladder's scaled sizes from a 1080p source (Apple's HLS authoring
# specification, 16:9): 1.5x to 4.6x downscales, cells up to 720 rows, and
# 234 rows whose chroma cell (117 rows) is odd
HLS = [(1280, 720), (960, 540), (768, 432), (640, 360), (416, 234)]


def _hls_plan(rung):
    return matscale.plan_scale(identity_uniforms((1920, 1080), rung), rung,
                               (1080, 1920))


@pytest.mark.parametrize("rung", HLS, ids=lambda r: f"{r[0]}x{r[1]}")
def test_hls_rung_on_the_row_and_the_tile_kernel_on_card(card, rung):
    """A 16-frame 1080p batch to one HLS rung: the batch scale is one
    launch of the row kernel (as the C entry counts it), the same plan on
    the tile kernel (``on_tiles``) one launch of that, and both canvases
    bit for bit the plain per-cell fold."""
    n = 16
    ys, us, vs = _y420p(np.random.default_rng(rung[1]), 1920, 1080, card, n)
    plan = _hls_plan(rung)
    unis = np.broadcast_to(plan.uniform, (n, 29))
    spans.start()
    try:
        rows = matscale.scale_y420p_batch(ys, us, vs, plan)
        torch.cuda.synchronize()
    finally:
        rec = spans.stop()
    assert (rec.counters.get("frame.cell_launches"),
            rec.counters.get("frame.cell_row_launches", 0)) == (1, 1)
    kept = frame.cell_plan(rung, None, [ys, us, vs], PF.y420p, unis)
    tiles = [torch.empty(*s, dtype=torch.uint8, device=card)
             for s in kept.out_shapes]
    spans.start()
    try:
        frame._launch_cells(kept.on_tiles(), tiles, [ys, us, vs], card)
        torch.cuda.synchronize()
    finally:
        rec = spans.stop()
    assert (rec.counters.get("frame.cell_launches"),
            rec.counters.get("frame.cell_row_launches", 0)) == (1, 0)
    want = composite.composite_cells_torch(
        rung, [([ys[i], us[i], vs[i]], PF.y420p, unis[i]) for i in range(n)],
        card)
    for r, t, w in zip(rows, tiles, want):
        assert r.reshape(w.shape).is_cuda and t.shape == w.shape
        assert torch.equal(t, w)
        assert torch.equal(r.reshape(w.shape), w)


# the ladders through matscale.scale_ladder: (source size, rungs, kernel
# launches a ladder), the row kernel taking two rungs a launch; the tiny
# ladder's last rung has a 13x7 chroma cell
_LADDERS = {
    "hls": ((1920, 1080), HLS, 3),
    "tiny": ((96, 54), [(64, 36), (48, 28), (26, 14)], 2),
}


@pytest.mark.parametrize("name", list(_LADDERS))
def test_ladder_makes_one_call_on_card(card, name):
    """A ladder of a 16-frame batch: one ``frame.cells`` span with its one
    ``frame.launch`` inside ``matscale.ladder``, the rungs' launches
    merged two to a row-kernel launch (the C entry's count, and the
    profiler's), no product, each rung bit for bit the rung's own batch
    scale and the plain reference (``svbench/reference/ladder.py``)."""
    from svbench.reference import ladder as ref_ladder
    size, rungs, made = _LADDERS[name]
    n = 16
    batch = _y420p(np.random.default_rng(5), *size, card, n)
    plans = [matscale.plan_scale(identity_uniforms(size, r), r, size[::-1])
             for r in rungs]
    launches, products = frame.launches, matscale.calls
    spans.start()
    try:
        got = matscale.scale_ladder(*batch, plans)
        torch.cuda.synchronize()
    finally:
        rec = spans.stop()
    assert (frame.launches - launches, matscale.calls) == (made, products)
    assert (rec.counters.get("frame.cell_launches"),
            rec.counters.get("frame.cell_row_launches", 0)) == (made, made)
    names = [rec.names[k] for k in rec.name]
    assert names == ["matscale.ladder", "frame.cells", "frame.launch"]
    assert rec.parent.tolist() == [-1, 0, 1]
    assert _launches_a_call(lambda: matscale.scale_ladder(*batch, plans),
                            made)
    for rung, plan, planes in zip(rungs, plans, got):
        w, h = rung
        assert [tuple(p.shape) for p in planes] == [
            (n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2)]
        want = matscale.scale_y420p_batch(*batch, plan)
        assert all(torch.equal(g, e) for g, e in zip(planes, want))
        for c in range(n):
            ref = ref_ladder.rung([p[c] for p in batch], rung)
            assert all(torch.equal(g[c], e) for g, e in zip(planes, ref))


@pytest.mark.parametrize("n,cols,rows,cell", [
    (64, 8, 8, (240, 136)), (60, 8, 8, (240, 136)), (64, 5, 13, (34, 18)),
    (40, 7, 6, (34, 18)), (100, 12, 9, (34, 18)), (70, 40, 2, (34, 18))],
    ids=lambda v: str(v))
def test_cell_canvas_matches_plain_canvas_on_card(card, n, cols, rows, cell):
    """Frames straight onto a canvas of cell rows and columns: bit for bit
    the plain canvas (each source alone on its cleared cell, every other
    cell cleared), chained bands included (5, 7, 12 and 40 columns do not
    divide 32); one FrameParams per 32 cells, launched as the kept plan
    reports them (the profiler agrees), and new frames at new addresses
    through the same kept table."""
    rng = np.random.default_rng(n + cols)
    unis = _cell_unis(n, (192, 108), cell, rng)
    for _ in range(2):
        ys, us, vs = _y420p(rng, 192, 108, card, n)
        launches, calls = frame.launches, composite.calls
        got = frame.composite_cells_cuda(cell, [ys, us, vs], PF.y420p, unis,
                                         grid=(cols, rows))
        plan = frame.cell_plan(cell, (cols, rows), [ys, us, vs], PF.y420p,
                               unis)
        made = frame.launches - launches
        assert len(plan.words) == -(-n // CAP)
        assert 1 <= made <= len(plan.words)
        assert composite.calls == calls
        assert _launches_a_call(lambda: frame.composite_cells_cuda(
            cell, [ys, us, vs], PF.y420p, unis, grid=(cols, rows)), made)
        want = composite.composite_cells_torch(
            cell, [([ys[i], us[i], vs[i]], PF.y420p, unis[i])
                   for i in range(n)], card, grid=(cols, rows))
        for g, w in zip(got, want):
            assert g.is_cuda and g.shape == w.shape and torch.equal(g, w)


def test_wall_canvas_on_card_over_chained_launches(card):
    """40 streams on a 7x6 wall: the per-cell tick is two launches, the
    second chained onto the row they share; the canvas equals the plain
    one and the audio the host sum."""
    rng = np.random.default_rng(41)
    n, sw, sh = 40, 96, 54
    wall = MixingWall(n_streams=n, stream_size=(sw, sh), canvas_size=(224, 108),
                      grid=(7, 6))
    assert wall.tile == (32, 18)
    ys, us, vs = _y420p(rng, sw, sh, card, n)
    pcm = rng.integers(-32768, 32768, (n, 96), np.int64).astype(np.int16)
    unis = _cell_unis(n, (sw, sh), wall.tile, rng)
    launches, calls = frame.launches, composite.calls
    out = wall.step(ys, us, vs, wall.shard(pcm), uniforms=unis)
    assert frame.launches == launches + 2 and composite.calls == calls
    want = composite.composite_cells_torch(
        wall.tile, [([ys[i], us[i], vs[i]], PF.y420p, unis[i])
                    for i in range(n)], card, grid=(7, 6))
    assert all(torch.equal(g, w) for g, w in zip(out[:3], want))
    host = np.clip(pcm.astype(np.int64).sum(0), -32768, 32767)
    assert np.array_equal(out[3].cpu().numpy(), host)


@pytest.mark.parametrize("n,grid,canvas,made", [
    (64, (8, 8), (256, 144), 1), (40, (7, 6), (224, 108), 2)],
    ids=["64 on 8x8", "40 on 7x6"])
def test_kept_cell_plan_on_card(card, n, grid, canvas, made):
    """The cell wrapper's kept plan: three batches at new addresses, then a
    change of uniforms; each canvas 0 LSB against the plain canvas, the
    first three from one plan; the C entry's launches as it counts them
    (two FrameParams as one launch of the row kernel, or two where the
    second is chained); the words it launched equal the plan's words on
    the host (``cell_params``), launch by launch, and its launches give
    the same canvas."""
    rng = np.random.default_rng(n)
    sw, sh = 96, 54
    cell = (canvas[0] // grid[0], canvas[1] // grid[1])
    unis = _cell_unis(n, (sw, sh), cell, rng)
    plans = []
    for k in range(4):
        if k == 3:
            unis = unis.copy()
            unis[2] = identity_uniforms((sw, sh), cell, opacity=0.5).pack()
        planes = _y420p(rng, sw, sh, card, n)
        launches = frame.launches
        got = frame.composite_cells_cuda(cell, planes, PF.y420p, unis,
                                         grid=grid)
        plans.append(frame.cell_plan(cell, grid, planes, PF.y420p, unis))
        assert frame.launches == launches + made
        want = composite.composite_cells_torch(
            cell, [([p[i] for p in planes], PF.y420p, unis[i])
                   for i in range(n)], card, grid=grid)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        plan = plans[-1]
        echo = np.zeros_like(plan.words)
        outs = [torch.empty_like(g) for g in got]
        frame._launch_cells(plan, outs, planes, card, echo=echo)
        host = frame.cell_params(cell, grid, planes, PF.y420p, unis, outs)
        assert np.array_equal(echo, np.stack(host))
        torch.cuda.synchronize()
        assert all(torch.equal(o, g) for o, g in zip(outs, got))
    assert plans[0] is plans[1] is plans[2] is not plans[3]


@pytest.mark.parametrize("n", [16, 14], ids=["aligned 16", "blank-fill 14"])
def test_wall_plan_and_per_cell_paths_on_card(card, n):
    """Both paths are one cell launch (n <= 32), no product and no plain
    call, each tile 0 LSB against the plain composite of its stream; audio
    equal to the host sum."""
    rng = np.random.default_rng(n)
    sw, sh = 192, 108
    wall = MixingWall(n_streams=n, stream_size=(sw, sh), canvas_size=(256, 128))
    assert wall.device.type == "cuda" and wall.aligned == (n == 16)
    ys, us, vs = _y420p(rng, sw, sh, card, n)
    pcm = rng.integers(-32768, 32768, (n, 96), np.int64).astype(np.int16)
    tw, th = wall.tile
    unis = wall.default_uniforms()
    unis[0] = identity_uniforms((sw, sh), (tw, th), opacity=0.5).pack()
    launches, products, calls = frame.launches, matscale.calls, composite.calls
    plan_out = wall.step(ys, us, vs, wall.shard(pcm))
    assert frame.launches == launches + 1
    cell_out = wall.step(ys, us, vs, wall.shard(pcm), uniforms=unis)
    assert frame.launches == launches + 2
    assert (matscale.calls, composite.calls) == (products, calls)
    host = np.clip(pcm.astype(np.int64).sum(0), -32768, 32767)
    for out in (plan_out, cell_out):
        assert out[3].is_cuda and np.array_equal(out[3].cpu().numpy(), host)
    for s in range(16):
        cells, cells_k = _cell(plan_out, s, 4, wall.tile), \
            _cell(cell_out, s, 4, wall.tile)
        if s >= n:
            for cell in (cells, cells_k):
                assert int(cell[0].max()) == 0
                assert all(bool((p == 128).all()) for p in cell[1:])
            continue
        planes = [ys[s], us[s], vs[s]]
        want = _plain_scale(card, planes, (sw, sh), (tw, th))
        assert all(torch.equal(g, w) for g, w in zip(cells, want))
        want_k = composite.composite_stack_torch(
            PF.y420p, (tw, th), [(planes, PF.y420p, unis[s])], card)
        assert all(torch.equal(g, w) for g, w in zip(cells_k, want_k))


# --- the wall's audio mix kernel (csrc/audio_mix.cu) ---------------------

# 64 x 1600: the wall64 cell's tick (16-byte copies); 1, 7, 13 and 1604
# samples are not whole 16-byte pieces (2-byte loads), and leave a block's
# tail; 8 and 24 are whole pieces with fewer samples than a block's 64; 130
# and 70 streams stage more than one tile of 64 streams
@pytest.mark.parametrize("streams,samples", [(64, 1600), (64, 1920), (5, 1),
                                             (3, 7), (40, 13), (64, 1604),
                                             (17, 8), (33, 24), (130, 1600),
                                             (70, 13)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("kind", EXACT_KINDS + ["random"])
def test_wall_audio_kernel_matches_plain_on_card(card, kind, streams,
                                                 samples):
    """Bit-exact against the plain version where every sum is exact, and
    against the in-order emulation for every gain; one launch a call."""
    pcm, gains = wall_audio_case(kind, streams, samples, streams * samples)
    launches = audio.launches
    got = audio.mix_wall_s16_cuda(pcm.to(card), gains.to(card))
    assert audio.launches == launches + 1
    assert got.is_cuda and got.dtype == torch.int16 and got.shape == (samples,)
    got = got.cpu()
    assert torch.equal(got, audio.mix_wall_s16_in_order(pcm, gains))
    if kind != "random":
        assert torch.equal(got, audio.mix_wall_s16_torch(pcm, gains))
        plain = audio.mix_wall_s16_torch(pcm.to(card), gains.to(card))
        assert torch.equal(got, plain.cpu())


def test_wall_audio_kernel_sums_in_stream_order_on_card(card):
    """2**24 + 1 rounds back to 2**24 in float32: stream 0 first gives 0
    where the reverse order gives 1, with 16-byte copies and 2-byte
    loads."""
    for samples in (8, 3):
        pcm = torch.tensor([[16384] * samples, [1] * samples,
                            [-16384] * samples], dtype=torch.int16)
        gains = torch.tensor([1024.0, 1.0, 1024.0])
        got = audio.mix_wall_s16_cuda(pcm.to(card), gains.to(card))
        assert got.cpu().tolist() == [0] * samples


def test_wall_audio_kernel_on_unaligned_rows_on_card(card):
    """Audio whose first row starts 2 bytes past a 16-byte boundary is
    staged with 2-byte loads, with the same result."""
    pcm, gains = wall_audio_case("random", 64, 1600, 7)
    buf = torch.zeros(64 * 1600 + 1, dtype=torch.int16, device=card)
    buf[1:] = pcm.reshape(-1).to(card)
    shifted = buf[1:].view(64, 1600)
    assert shifted.data_ptr() % 16 == 2 and shifted.is_contiguous()
    got = audio.mix_wall_s16_cuda(shifted, gains.to(card))
    assert torch.equal(got.cpu(), audio.mix_wall_s16_in_order(pcm, gains))


def test_wall_audio_kernel_refuses_host_gains_on_card(card):
    pcm, gains = wall_audio_case("unity", 4, 16, 3)
    launches = audio.launches
    with pytest.raises(ValueError):
        audio.mix_wall_s16_cuda(pcm.to(card), gains)
    assert audio.launches == launches


def _cell(wall_planes, s, gw, tile):
    """Cell ``s`` of a gw-wide wall's three planes."""
    r, c = divmod(s, gw)
    tw, th = tile
    return [p[r * h:(r + 1) * h, c * w:(c + 1) * w]
            for p, (w, h) in zip(wall_planes, ((tw, th), (tw // 2, th // 2),
                                               (tw // 2, th // 2)))]


def test_uploads_in_flight_equal_their_sources_on_card(card):
    """Eight 1080p y420p frames, two alternating host buffers, uploaded
    with no sync between them: once the card has run every copy, each
    device tensor equals its source (a page-locked block reused while its
    copy was in flight would not)."""
    rng = np.random.default_rng(31)
    frames = [[rng.integers(0, 256, s, np.int64).astype(np.uint8)
               for s in ((1080, 1920), (540, 960), (540, 960))]
              for _ in range(2)]
    got = [[barriers.upload(p, card) for p in frames[k % 2]]
           for k in range(8)]
    torch.cuda.synchronize()
    for k, planes in enumerate(got):
        for d, p in zip(planes, frames[k % 2]):
            assert d.is_cuda and np.array_equal(d.cpu().numpy(), p)
