"""The port's kernels on an NVIDIA card: the frame kernel (yuv and RGBA /
BGRA targets) and the motion search (SAD and SSD) against their plain torch
versions on the same CUDA tensors, the two-stage motion search (the
coarse kernel on the stride-2 grid, K5's coarse mode on the stride-1 grid,
and the refine kernel) against its plain version, and the audio
folds against the host loop; the batch paths: the ladder's products (<= 1 LSB against the plain
composite, and raising under the TF32 switches), the batched fold (exact),
the device resampler (< 1e-4 against the host route) and the SRC stage's
bookkeeping, and the mixing wall's plan path (<= 1 LSB) and per-cell path
(0 LSB, one frame-kernel launch per stream).  Marked ``cuda``; they skip where there is no card.  Run them on the
card with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerance: 0 LSB for pixels (the frame kernels are bit-exact against the
plain version), exact for motion vectors and audio.  The frame cases cover
every target the kernel writes (packed 4:2:2 through the registry), both of the kernels' map paths (the row side once per run for axis-aligned
sources, every map per pixel for rotated ones), downscales and upscales,
ragged runs, stacks longer than one launch and chained targets.  Imports
only the port."""

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch.core import TimePoint
from swiftvideo_tpu_torch.media import PixelFormat as PF
from swiftvideo_tpu_torch.media.audio import AudioFormat, AudioSample
from swiftvideo_tpu_torch.mix.src_audio import AudioSampleRateConversion
from swiftvideo_tpu_torch.ops import (audio, composite, frame, matscale,
                                      motion, registry, resample)
from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms, rect_uniforms
from swiftvideo_tpu_torch.parallel import MixingWall

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
    planes = _y420p(np.random.default_rng(rung[0]), 1920, 1080, card)
    plan = matscale.plan_scale(identity_uniforms((1920, 1080), rung), rung,
                               (1080, 1920))
    got = matscale.scale_y420p(planes, plan)
    want = _plain_scale(card, planes, (1920, 1080), rung)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.uint8 and g.shape == w.shape
        assert int((g.int() - w.int()).abs().max()) <= 1


@pytest.mark.parametrize("switch", ["allow_tf32", "precision high"])
def test_ladder_and_resampler_raise_under_tf32_on_card(card, switch):
    """The TF32 switches would put the products on TF32 and lose the 1 LSB
    contract: the calls raise instead."""
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
            matscale.scale_y420p(planes, plan)
        with pytest.raises(RuntimeError, match="full float32"):
            rs.process(np.zeros((2, 4096), np.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision(before)
    got = matscale.scale_y420p(planes, plan)
    want = _plain_scale(card, planes, (1920, 1080), (640, 360))
    assert max(int((g.int() - w.int()).abs().max())
               for g, w in zip(got, want)) <= 1


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


@pytest.mark.parametrize("n", [16, 14], ids=["aligned 16", "blank-fill 14"])
def test_wall_plan_and_per_cell_paths_on_card(card, n):
    """Plan path <= 1 LSB against the plain composite of each stream;
    per-cell path 0 LSB with one frame-kernel launch per stream; audio
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
    launches = frame.launches
    plan_out = wall.step(ys, us, vs, wall.shard(pcm))
    assert frame.launches == launches
    cell_out = wall.step(ys, us, vs, wall.shard(pcm), uniforms=unis)
    assert frame.launches == launches + n
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
        assert max(int((g.int() - w.int()).abs().max())
                   for g, w in zip(cells, want)) <= 1
        want_k = composite.composite_stack_torch(
            PF.y420p, (tw, th), [(planes, PF.y420p, unis[s])], card)
        assert all(torch.equal(g, w) for g, w in zip(cells_k, want_k))


def _cell(wall_planes, s, gw, tile):
    """Cell ``s`` of a gw-wide wall's three planes."""
    r, c = divmod(s, gw)
    tw, th = tile
    return [p[r * h:(r + 1) * h, c * w:(c + 1) * w]
            for p, (w, h) in zip(wall_planes, ((tw, th), (tw // 2, th // 2),
                                               (tw // 2, th // 2)))]
