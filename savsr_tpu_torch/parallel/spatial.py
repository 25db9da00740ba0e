"""Spatial sharding of the eval forward: each frame split by height over the
``S`` ranks of a band group (``mesh: {data: D, spatial: S}``).

The port's counterpart of the JAX package's ``spatial`` mesh axis
(``savsr_tpu/parallel/mesh.py`` ``shard_or_replicate_batch``), where XLA
inserts the halo exchanges. Here they are explicit, as plain functions on
tensors, over point-to-point sends and receives within the band group:

- geometry: the bands of the padded LR frame (``band_rows``: even starts,
  so that OSAdapt's ``AvgPool2d(2)`` pairs the whole frame's rows; no band
  thinner than ``MASK_REACH``), the HR rows each band produces
  (``hr_band_rows``) and the LR rows their STAU samplers reach
  (``stau_reach``);
- ``halo_exchange``: a feature carries ``HALO`` rows beyond its band on
  each side in its own tensor ([B, C, rows + 2 HALO, W]); the exchange
  fills them from the neighbouring bands, zeros at the frame's true edges
  (the convs' zero padding), in place, and marks the tensor fresh
  (``is_fresh``), so that a feature read by several convs is exchanged once;
- ``neighbour_rows`` / ``extend_rows``: the ``n`` rows beyond a band from
  its neighbours (the OSAdapt mask head's and STA's reach);
- ``band_row_sums``: the per-row sums of the bands put together into the
  whole frame's (an all-reduce of zero-padded rows: each element has one
  nonzero term, so it is exact), so that a sum over the rows taken after
  it equals the one-process sum to the bit;
- ``fetch_rows``: any rows of a frame held in bands, from the bands that
  hold them (the STAU's LR window, and ``gather_rows``, the HR frame put
  together on band 0).

Gloo's point-to-point calls read host memory only, so over gloo a CUDA
tensor is staged through the host for every call (the card machine runs
several ranks on its one card over gloo); NCCL sends device memory.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# rows a feature carries beyond its band on each side: one 3x3 conv's reach
HALO = 1
# rows beyond a band that the OSAdapt mask head reads (conv, AvgPool2d(2),
# two half-resolution convs, bilinear x2, conv: 7 rows, rounded up to keep
# the pooling's pairs); the widest halo, so the thinnest band
MASK_REACH = 8
# rows beyond a band that STA's 5x5 filter reads
STA_REACH = 2

Rows = Tuple[int, int]


@dataclass(frozen=True)
class BandGroup:
    """This rank's place among the ``count`` ranks that share a frame:
    its band ``index``, the group's global ``ranks`` in band order, their
    process ``group`` and its ``backend``; in a forward, ``rows``, the
    bands of the current frame (``band_rows``; ``dataclasses.replace``
    sets them). ``stats`` counts the exchanges made (each call of a
    function here that moves rows) and the bytes of the buffers this rank
    sent in them (an all-reduce's buffer counted once)."""

    index: int
    count: int
    ranks: Tuple[int, ...]
    group: Any = None
    backend: str = "gloo"
    rows: Tuple[Rows, ...] = ()
    stats: Dict[str, int] = field(default_factory=lambda: {"exchanges": 0, "bytes": 0})

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.count - 1


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def band_rows(height: int, count: int) -> List[Rows]:
    """The ``count`` bands [start, stop) of a frame of ``height`` rows (the
    padded LR height, even): as equal as 2-row steps allow, every start
    even. Raises ValueError where a band is thinner than the widest halo."""
    if height % 2:
        raise ValueError(f"spatial: the padded frame height {height} is odd")
    pairs = height // 2
    rows = [(2 * (i * pairs // count), 2 * ((i + 1) * pairs // count)) for i in range(count)]
    thin = min(b - a for a, b in rows)
    if thin < MASK_REACH:
        raise ValueError(
            f"spatial: {count} bands of a {height}-row frame leave a band of {thin} rows, "
            f"thinner than the widest halo ({MASK_REACH} rows, the OSAdapt mask head's "
            "reach): use fewer bands (mesh: spatial) or taller frames")
    return rows


def crop_rows(rows: Sequence[Rows], height: int) -> List[Rows]:
    """The bands cut to a frame of ``height`` rows (the crop to the
    unpadded height: the last band gives up the reflected row)."""
    return [(a, min(b, height)) for a, b in rows]


def hr_band_rows(rows: Sequence[Rows], h: int, H: int) -> List[Rows]:
    """The HR rows [Y0, Y1) that each band produces: band i from row
    floor(start_i H / h) of the ``H``-row output of an ``h``-row LR frame,
    the last to the end."""
    starts = [0] + [a * H // h for a, _ in rows[1:]] + [H]
    out = list(zip(starts[:-1], starts[1:]))
    if any(b <= a for a, b in out):
        raise ValueError(f"spatial: the LR bands {list(rows)} leave an HR band of {out} empty")
    return out


def stau_reach(pix: torch.Tensor, hr_rows: Sequence[Rows], h: int) -> List[Rows]:
    """For each range of HR rows, the LR rows [L0, L1) of an ``h``-row frame
    that its bilinear taps (floor and floor + 1 of the fy planes 0 and 2 of
    ``pix``) reach inside the frame, clipped to it and never empty: a tap
    outside that window is a tap outside the frame."""
    fy = torch.floor(torch.nan_to_num(pix[[0, 2]].float()))
    lo = fy.amin(dim=(0, 2))
    hi = fy.amax(dim=(0, 2))
    out = []
    for y0, y1 in hr_rows:
        f_lo, f_hi = float(lo[y0:y1].min()), float(hi[y0:y1].max())
        out.append((int(min(max(f_lo, 0), h - 1)), int(min(max(f_hi + 1, 0), h - 1)) + 1))
    return out


def _clip(r: Rows, lo: int, hi: int) -> Rows:
    return max(r[0], lo), min(r[1], hi)


# ---------------------------------------------------------------------------
# point-to-point
# ---------------------------------------------------------------------------


def _stage(t: torch.Tensor, band: BandGroup) -> torch.Tensor:
    """``t`` where the backend can send it from: the host for gloo."""
    t = t.contiguous()
    return t.cpu() if band.backend != "nccl" and t.is_cuda else t


def _p2p(band: BandGroup, sends: Dict[int, torch.Tensor],
         recvs: Dict[int, Tuple[torch.Size, torch.dtype]], device) -> Dict[int, torch.Tensor]:
    """Send ``sends[j]`` to band j and receive a tensor of ``recvs[j]``'s
    (shape, dtype) from band j, all at once; returns what was received, on
    ``device``. Every band of the group calls this together."""
    band.stats["exchanges"] += 1
    ops, got = [], {}
    on_host = band.backend != "nccl" and torch.device(device).type == "cuda"
    for j, t in sends.items():
        t = _stage(t, band)
        band.stats["bytes"] += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t, band.ranks[j], band.group))
    for j, (shape, dtype) in recvs.items():
        got[j] = torch.empty(shape, dtype=dtype, device="cpu" if on_host else device)
        ops.append(dist.P2POp(dist.irecv, got[j], band.ranks[j], band.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return {j: t.to(device) for j, t in got.items()}


def neighbour_rows(tensors: Sequence[torch.Tensor], band: BandGroup, n: int):
    """The ``n`` rows above and below this band of each of ``tensors`` (each
    this band's rows only, dim 2), from the neighbouring bands: (above,
    below), two lists, None at the frame's true edges. The tensors travel
    as one message a neighbour (they share a dtype)."""
    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts])

    shapes = [(t.shape[0], t.shape[1], n, t.shape[3]) for t in tensors]
    size = sum(s[0] * s[1] * s[2] * s[3] for s in shapes)
    sends, recvs = {}, {}
    dtype, device = tensors[0].dtype, tensors[0].device
    if not band.first:
        sends[band.index - 1] = flat([t[:, :, :n] for t in tensors])
        recvs[band.index - 1] = ((size,), dtype)
    if not band.last:
        sends[band.index + 1] = flat([t[:, :, t.shape[2] - n:] for t in tensors])
        recvs[band.index + 1] = ((size,), dtype)
    got = _p2p(band, sends, recvs, device)

    def unflat(j):
        if j not in got:
            return None
        out, off = [], 0
        for s in shapes:
            k = s[0] * s[1] * s[2] * s[3]
            out.append(got[j][off:off + k].view(s))
            off += k
        return out

    return unflat(band.index - 1), unflat(band.index + 1)


def extend_rows(t: torch.Tensor, band: BandGroup, n: int) -> Tuple[torch.Tensor, int]:
    """This band's rows ``t`` with the ``n`` rows beyond them on each side
    from the neighbours (none beyond the frame's true edges), and how many
    rows came before ``t``'s."""
    above, below = neighbour_rows([t], band, n)
    ext = torch.cat(([] if above is None else above) + [t] + ([] if below is None else below),
                    dim=2)
    return ext, 0 if above is None else n


def is_fresh(t: torch.Tensor) -> bool:
    """Whether ``t``'s halo rows hold its neighbours' rows (or the frame's
    zero padding) since it was made."""
    return getattr(t, "_savsr_halo_fresh", False)


def mark_fresh(*tensors: torch.Tensor) -> None:
    """Mark tensors whose halo rows are right by construction (the input
    frames' bands, zero states)."""
    for t in tensors:
        t._savsr_halo_fresh = True


def halo_exchange(tensors: Sequence[torch.Tensor], band: BandGroup) -> None:
    """Fill the ``HALO`` rows on each side of each of ``tensors`` ([B, C,
    rows + 2 HALO, W]) from the neighbouring bands' edge rows, with zeros at
    the frame's true edges, in place, and mark them fresh. One message a
    neighbour for all of them."""
    inner = [t[:, :, HALO:t.shape[2] - HALO] for t in tensors]
    above, below = neighbour_rows(inner, band, HALO)
    for i, t in enumerate(tensors):
        for rows, got in ((t[:, :, :HALO], above), (t[:, :, t.shape[2] - HALO:], below)):
            if got is None:
                rows.zero_()
            else:
                rows.copy_(got[i])
    mark_fresh(*tensors)


def band_row_sums(t: torch.Tensor, band: BandGroup) -> torch.Tensor:
    """The whole frame's per-row values [B, C, height] from each band's
    ``t`` [B, C, rows] (its rows of ``band.rows``): every band places its
    rows in zeros and the group adds them, each element one nonzero term
    and zeros, so every band gets the rows exactly."""
    band.stats["exchanges"] += 1
    a, b = band.rows[band.index]
    full = t.new_zeros(t.shape[:2] + (band.rows[-1][1],))
    full[:, :, a:b] = t
    src = _stage(full, band)
    band.stats["bytes"] += src.numel() * src.element_size()
    dist.all_reduce(src, group=band.group)
    return src.to(t.device)


def fetch_rows(t: torch.Tensor, band: BandGroup, owned: Sequence[Rows],
               wants: Sequence[Optional[Rows]]) -> Optional[torch.Tensor]:
    """Rows of a frame held in bands: ``t`` is this band's rows ``owned[i]``
    of the frame (dim 2), and band j wants rows ``wants[j]`` (None: none).
    Each band sends every other band the wanted rows it holds and returns
    its own wanted rows, put together in order (None if it wants none)."""
    me = band.index
    sends, recvs = {}, {}
    b, c, _, w = t.shape
    for j in range(band.count):
        if j == me:
            continue
        if wants[j] is not None:
            lo, hi = _clip(wants[j], *owned[me])
            if lo < hi:
                sends[j] = t[:, :, lo - owned[me][0]:hi - owned[me][0]]
        if wants[me] is not None:
            lo, hi = _clip(wants[me], *owned[j])
            if lo < hi:
                recvs[j] = ((b, c, hi - lo, w), t.dtype)
    got = _p2p(band, sends, recvs, t.device)
    if wants[me] is None:
        return None
    pieces = []
    for j in range(band.count):
        if j == me:
            lo, hi = _clip(wants[me], *owned[me])
            if lo < hi:
                pieces.append(t[:, :, lo - owned[me][0]:hi - owned[me][0]])
        elif j in got:
            pieces.append(got[j])
    return torch.cat(pieces, 2) if len(pieces) > 1 else pieces[0].contiguous()


def gather_rows(t: torch.Tensor, band: BandGroup, owned: Sequence[Rows]) -> Optional[torch.Tensor]:
    """The frame put together on band 0 from every band's rows ``owned``
    (``t``: this band's); None on the other bands."""
    whole = (owned[0][0], owned[-1][1])
    return fetch_rows(t, band, owned, [whole] + [None] * (band.count - 1))
