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

Two video paths, as in the JAX package.  Default uniforms make every cell a
pure full-coverage scale: the whole batch goes through the two products of
``ops/matscale.scale_y420p_batch``.  Per-cell uniforms (aspect fit, offset,
opacity, fill) composite each stream onto a blank tile with
``ops/frame.composite_frame_cuda``: the frame kernel on the card (one
launch per cell), its plain version for CPU tensors.

Without a group the wall runs on one device, the card unless the caller
asks for the CPU; the aligned layout then holds exactly when the streams
fill the grid.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..media.pixel import PixelFormat
from ..ops import frame
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
        value)."""
        return np.broadcast_to(self._identity,
                               (self.local, self._identity.shape[0])).copy()

    def default_gains(self) -> torch.Tensor:
        """Unity gains for real streams, zero for padded blanks; this
        rank's slice."""
        return self.shard((np.arange(self.n_pad)
                           < self.n_streams).astype(np.float32))

    # --- one tick -----------------------------------------------------------
    def _scale_cells(self, ys, us, vs, uniforms):
        """Each of this rank's real streams onto its own blank tile with its
        own uniforms: one frame-kernel launch per stream on the card.
        Padded streams keep zero tiles, which ``_blank_fix`` blanks."""
        if isinstance(uniforms, torch.Tensor):
            uniforms = uniforms.cpu().numpy()
        uniforms = np.asarray(uniforms, np.float32)
        tw, th = self.tile
        tiles = (ys.new_zeros((self.local, th, tw)),
                 ys.new_zeros((self.local, th // 2, tw // 2)),
                 ys.new_zeros((self.local, th // 2, tw // 2)))
        real = min(self.local, self.n_streams - self.rank * self.local)
        for i in range(real):
            out = frame.composite_frame_cuda(
                (tw, th), [([ys[i], us[i], vs[i]], PixelFormat.y420p,
                            uniforms[i])], PixelFormat.y420p)
            for t, plane in zip(tiles, out):
                t[i] = plane
        return tiles

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

    def _mix_audio(self, audio: torch.Tensor, gains) -> torch.Tensor:
        gains = torch.as_tensor(gains, dtype=torch.float32,
                                device=audio.device)
        total = torch.sum(audio.to(torch.float32) * gains[:, None], dim=0)
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
        return torch.clamp(torch.trunc(total), -32768, 32767).to(torch.int16)

    def step(self, ys, us, vs, audio, gains=None, uniforms=None):
        """One wall tick over this rank's streams.  ys/us/vs: [local, ...]
        u8 planes; audio: [local, samples * channels] s16; gains: [local]
        float32; uniforms: optional [local, 29] per-cell composite uniforms.
        Returns (wall_y, wall_u, wall_v, mixed).

        Without uniforms, cells take the products of ops/matscale.py;
        per-cell uniforms take the frame kernel, one launch per cell."""
        if gains is None:
            gains = self.default_gains()
        if uniforms is None and self._plan is not None:
            tiles = scale_y420p_batch(ys, us, vs, self._plan)
        else:
            if uniforms is None:
                uniforms = self.default_uniforms()
            tiles = self._scale_cells(ys, us, vs, uniforms)
        return self._assemble(tiles) + (self._mix_audio(audio, gains),)
