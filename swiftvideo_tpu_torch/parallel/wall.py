"""Multi-stream mixing wall: N live streams scaled into a ``gw x gh`` grid
plus an N-way audio mix (BASELINE config 5).

The counterpart of ``swiftvideo_tpu/parallel/wall.py``.  The streams are a
batch axis; with a ``torch.distributed`` process group that axis is split
over the ranks as the JAX package splits it over a device mesh:

* video: each rank scales its own streams to wall tiles.  When every rank
  owns whole wall rows (the "aligned" layout) it returns its band of rows
  and runs no video collective; otherwise the u8 tiles go through one
  ``all_gather`` (equal sizes, thanks to padding) and every rank assembles
  the whole wall, with padded and excess cells blank;
* audio: each rank sums gain * sample over its streams in float32, one
  ``all_reduce`` adds the partial sums, then trunc and a clamp to s16.
  Without a group the whole mix is one launch of the wall's mix kernel on
  the card (``ops/audio.mix_wall_s16_cuda``), its plain version for CPU
  tensors.

Two video paths, as in the JAX package: default uniforms (every cell a
pure full-coverage scale) and per-cell uniforms (aspect fit, offset,
opacity, fill).  On the card both are the frame kernel's cell launch
(``ops/frame.composite_cells_cuda``), default cells with the identity
uniforms: on one card every stream goes straight onto its cell of the
wall canvas, and on an aligned rank layout onto the rank's band of rows,
one launch per 32 streams, with no assembly copy (a cell no stream fills
comes out blank from the kernel's clear); only the gathered layout
composites a tile stack and assembles it.  On the CPU default cells take
the two products of ``ops/matscale.scale_y420p_batch`` (the JAX package's
route) and per-cell uniforms the cell launch's plain version, one plain
composite per cell, and every layout assembles its tiles.

Without a group the wall runs on one device, the card unless the caller
asks for the CPU; the aligned layout then holds exactly when the streams
fill the grid.
"""

from __future__ import annotations

import math
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import spans
from ..media.pixel import PixelFormat
from ..ops import frame
from ..ops import audio as audio_ops
from ..ops.audio import saturate_s16, wall_sum_f32
from ..ops.composite import packed
from ..ops.matscale import plan_scale, scale_y420p_batch
from ..ops.registry import make_compute_context
from ..ops.uniforms import identity_uniforms

# a blank cell's planes: luma 0, chroma 128
_FILL = (0, 128, 128)


def _rows_assemble(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[rows * cols, h, w] tiles -> one [rows * h, cols * w] plane, row
    major."""
    _, h, w = t.shape
    return (t.reshape(rows, cols, h, w).permute(0, 2, 1, 3)
            .reshape(rows * h, cols * w))


class MixingWall:
    """Grid composite of ``n_streams`` onto a ``gw x gh`` wall.

    Streams arrive as batched dense y420p planes ``[N, H, W]`` (and half-res
    chroma) and interleaved s16 audio ``[N, samples * channels]``, each
    rank's share placed by ``shard``; ``step`` returns the wall planes and
    the mixed audio on ``device``: this rank's band of wall rows on
    aligned layouts, the whole wall otherwise.
    """

    def __init__(self, *, n_streams: int, stream_size: Tuple[int, int],
                 canvas_size: Tuple[int, int],
                 grid: Optional[Tuple[int, int]] = None,
                 audio_samples: int = 960, channels: int = 2,
                 device=None, group=None):
        self.device = make_compute_context(device).device
        self.group = group
        self.n_dev = n_dev = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        if grid is None:
            gw = int(math.ceil(math.sqrt(n_streams)))
            gh = int(math.ceil(n_streams / gw))
        else:
            gw, gh = grid
        if gw * gh < n_streams:
            raise ValueError(f"grid {gw}x{gh} holds fewer cells than "
                             f"{n_streams} streams")
        self.grid_wh = (gw, gh)
        self.n_streams = n_streams
        # stream counts that do not divide the ranks run padded with blank
        # cells (zero-gain audio)
        self.n_pad = -(-n_streams // n_dev) * n_dev
        self.local = self.n_pad // n_dev
        self.stream_size = stream_size
        cw, ch = canvas_size
        if cw % gw or ch % gh:
            raise ValueError("canvas must divide into the wall grid")
        if (cw // gw) % 2 or (ch // gh) % 2:
            raise ValueError("wall tiles must have even dims (4:2:0 chroma)")
        self.canvas_size = canvas_size
        self.tile = (cw // gw, ch // gh)  # (w, h)
        self.audio_samples = audio_samples
        self.channels = channels
        # aligned layout: no padding and every rank owns whole wall rows ->
        # no video collective, each rank keeps its band of rows
        self.aligned = (self.n_pad == n_streams and self.local % gw == 0
                        and gh % n_dev == 0
                        and self.local // gw == gh // n_dev)
        sw, sh = stream_size
        self._identity = packed(identity_uniforms(stream_size, self.tile))
        self._plan = plan_scale(self._identity, self.tile, (sh, sw))
        # the default cells' uniforms, built once (the frame kernel takes
        # uniforms by value, so the launch table stays the same each tick)
        self._unis = np.broadcast_to(
            self._identity, (self.local, self._identity.shape[0])).copy()
        self._unis.flags.writeable = False
        # on the card, the (columns, rows) of cells this rank writes straight
        # onto its output: the whole wall on one card, its band of rows on
        # an aligned rank layout; None where tiles are assembled
        self._canvas = None
        if self.device.type != "cpu":
            if group is None:
                self._canvas = (gw, gh)
            elif self.aligned:
                self._canvas = (gw, self.local // gw)

    # --- placement ----------------------------------------------------------
    def shard(self, array) -> torch.Tensor:
        """This rank's slice of a [N, ...] array (numpy or tensor) of every
        stream, zero-padded from N up to the padded count, on ``device``."""
        array = torch.as_tensor(array)
        if array.shape[0] != self.n_pad:
            pad = array.new_zeros((self.n_pad - array.shape[0],)
                                  + tuple(array.shape[1:]))
            array = torch.cat([array, pad])
        lo = self.rank * self.local
        return array[lo:lo + self.local].to(self.device).contiguous()

    def default_uniforms(self) -> np.ndarray:
        """Identity full-cell uniforms for this rank's streams, a host
        [local, 29] float32 array (the frame kernel takes uniforms by
        value); a copy of the one the wall keeps."""
        return self._unis.copy()

    @cached_property
    def _gains(self) -> torch.Tensor:
        """Unity gains for real streams, zero for padded blanks; this
        rank's slice on ``device``, built on first use and kept."""
        return self.shard((np.arange(self.n_pad)
                           < self.n_streams).astype(np.float32))

    def default_gains(self) -> torch.Tensor:
        """Unity gains for real streams, zero for padded blanks; this
        rank's slice (a copy of the one the wall keeps)."""
        return self._gains.clone()

    # --- one tick -----------------------------------------------------------
    @staticmethod
    def _host_uniforms(uniforms) -> np.ndarray:
        if isinstance(uniforms, torch.Tensor):
            uniforms = uniforms.cpu().numpy()
        return np.asarray(uniforms, np.float32)

    def _scale_cells(self, ys, us, vs, uniforms):
        """Each of this rank's real streams onto its own blank tile with its
        own uniforms: the frame kernel's cell launch on the card (one launch
        per 32 streams), the plain per-cell fold for CPU tensors.  Padded
        streams keep zero tiles, which ``_blank_fix`` blanks."""
        uniforms = self._host_uniforms(uniforms)
        tw, th = self.tile
        shapes = ((th, tw), (th // 2, tw // 2), (th // 2, tw // 2))
        real = max(0, min(self.local, self.n_streams - self.rank * self.local))
        if real == 0:
            return tuple(ys.new_zeros((self.local,) + s) for s in shapes)
        stack = [t.view((real,) + s) for t, s in zip(frame.composite_cells_cuda(
            (tw, th), [ys[:real], us[:real], vs[:real]], PixelFormat.y420p,
            uniforms[:real]), shapes)]
        if real == self.local:
            return tuple(stack)
        return tuple(torch.cat([t, t.new_zeros((self.local - real,) + s)])
                     for t, s in zip(stack, shapes))

    def _blank_fix(self, tiles: torch.Tensor, fill: int) -> torch.Tensor:
        """Blank the padded and excess cells: [n_pad, ...] tiles -> the
        grid's gw * gh cells."""
        gw, gh = self.grid_wh
        out = tiles.new_full((gw * gh,) + tuple(tiles.shape[1:]), fill)
        out[:self.n_streams] = tiles[:self.n_streams]
        return out

    def _assemble(self, tiles):
        gw, gh = self.grid_wh
        if self.aligned:
            rows = self.local // gw
            return tuple(_rows_assemble(t, rows, gw) for t in tiles)
        if self.group is not None:
            gathered = []
            for t in tiles:
                parts = [torch.empty_like(t) for _ in range(self.n_dev)]
                dist.all_gather(parts, t, group=self.group)
                gathered.append(torch.cat(parts))
            tiles = gathered
        return tuple(_rows_assemble(self._blank_fix(t, f), gh, gw)
                     for t, f in zip(tiles, _FILL))

    def _mix_audio(self, audio: torch.Tensor, gains=None) -> torch.Tensor:
        """The tick's mix: [local, samples] s16 audio with [local] gains (the
        kept unity gains for None) -> [samples] s16.  Card audio on a
        one-device wall takes the mix kernel; CPU audio takes the plain
        version, and a rank adds its float32 partial sum over the ranks
        before the trunc and clamp."""
        if spans.ON:
            spans.count("wall.audio_mixes")
        if gains is not None:
            gains = torch.as_tensor(gains, dtype=torch.float32,
                                    device=audio.device).contiguous()
        elif audio.is_cuda:
            gains = self._gains
        else:
            gains = self._gains.cpu()
        if self.group is not None or not audio.is_cuda:
            total = wall_sum_f32(audio, gains)
            if self.group is not None:
                dist.all_reduce(total, group=self.group)
            return saturate_s16(total)
        launched = audio_ops.launches
        mixed = audio_ops.mix_wall_s16_cuda(audio, gains)
        if spans.ON and audio_ops.launches != launched:
            spans.count("wall.audio_kernel_mixes")
        return mixed

    def step(self, ys, us, vs, audio, gains=None, uniforms=None):
        """One wall tick over this rank's streams.  ys/us/vs: [local, ...]
        u8 planes; audio: [local, samples * channels] s16 (contiguous on
        the card); gains: [local] float32 (the wall's kept unity gains
        without them);
        uniforms: optional [local, 29] per-cell composite uniforms.  Returns
        (wall_y, wall_u, wall_v, mixed).

        On the card every cell takes the frame kernel's cell launch, with
        the identity uniforms without ``uniforms``, straight onto the wall
        (one card) or this rank's band (aligned ranks); on the CPU default
        cells take the products of ops/matscale.py, per-cell uniforms the
        plain per-cell fold, and the tiles are assembled.  The audio mix
        comes after the cell launches, so that its launch's host time runs
        while the card composites."""
        span = spans.ON and spans.begin("wall.step")
        if uniforms is None:
            uniforms = self._unis
        if self._canvas is not None:
            # a cell past the last stream comes out blank (luma 0, chroma
            # 128: the kernel's clear)
            video = tuple(frame.composite_cells_cuda(
                self.tile, [ys, us, vs], PixelFormat.y420p,
                self._host_uniforms(uniforms), grid=self._canvas))
        elif (uniforms is self._unis and self._plan is not None
                and self.device.type == "cpu"):
            video = self._assemble(scale_y420p_batch(ys, us, vs, self._plan))
        else:
            video = self._assemble(self._scale_cells(ys, us, vs, uniforms))
        part = span and spans.begin("wall.audio")
        mixed = self._mix_audio(audio, gains)
        if span:
            spans.end(part)
            spans.end(span)
        return video + (mixed,)
