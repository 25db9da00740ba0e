"""Spatial sharding of the eval forward and of the training step: each frame
split by height over the ``S`` ranks of a band group (``mesh: {data: D,
spatial: S}``).

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
  together on band 0);
- ``share_batch``: band 0's training batch on every band of its group.

The training step's counterparts are ``torch.autograd.Function``s whose
backward is the transpose of their forward, over the same point-to-point
calls and all-reduces: ``extend_rows_train`` (the halo rows; the backward
sends each band the gradient of the rows it lent and adds what comes back
into the edge rows), ``band_row_sums_train`` (the backward sums the
cotangent over the band group, then takes this band's rows: every band
differentiates only its own share of the loss) and ``fetch_window_train``
(the STAU's window, placed in zeros of the frame's height; the backward
returns the window's gradient rows to their owners). Every band of a group
issues the same calls in the same order, forward and backward, a band with
nothing to send included, so the collectives stay matched.

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
    data: int = 1
    data_group: Any = None
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


def sampler_rows(hr_rows: Sequence[Rows], H: int) -> List[Rows]:
    """Each band's HR rows with one row beyond on each side, clipped to the
    ``H``-row output: the rows a band's STAU produces, so that the tail's
    3x3 has its neighbours."""
    return [(max(y0 - 1, 0), min(y1 + 1, H)) for y0, y1 in hr_rows]


def frame_hr_rows(h: int, H: int, count: int) -> List[Rows]:
    """The HR rows of each of ``count`` bands of an ``h``-row LR frame with
    an ``H``-row output (the bands of the padded frame, ``band_rows``): a
    training step's band produces and scores these rows of ``gt``."""
    return hr_band_rows(band_rows(h + h % 2, count), h, H)


def stau_reach(pix: torch.Tensor, hr_rows: Sequence[Rows], h: int) -> List[Rows]:
    """For each range of HR rows, the LR rows [L0, L1) of an ``h``-row frame
    that its bilinear taps (floor and floor + 1 of the fy planes 0 and 2 of
    ``pix``) reach inside the frame, clipped to it and never empty: a tap
    outside that window is a tap outside the frame."""
    return window_reach(pix[[0, 2]], hr_rows, h)


def window_reach(fy: torch.Tensor, hr_rows: Sequence[Rows], h: int,
                 margin: int = 0) -> List[Rows]:
    """``stau_reach`` of the LR row coordinates ``fy`` [k, H, W] (one plane
    a sampler), each window widened by ``margin`` rows on each side (the
    training step's, whose coordinates the sampler rounds in its own
    arithmetic), clipped to the frame. One device-to-host read."""
    fy = torch.floor(torch.nan_to_num(fy.detach().float()))
    lo, hi = torch.stack([fy.amin(dim=(0, 2)), fy.amax(dim=(0, 2))]).cpu()
    out = []
    for y0, y1 in hr_rows:
        f_lo, f_hi = float(lo[y0:y1].min()) - margin, float(hi[y0:y1].max()) + margin
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
    a, b = band.rows[band.index]
    full = t.new_zeros(t.shape[:2] + (band.rows[-1][1],))
    full[:, :, a:b] = t
    return _group_sum(full, band)


def share_batch(lq: torch.Tensor, gt: torch.Tensor, scale, band: BandGroup):
    """Band 0's training batch (lq [B, T, C, h, w], gt [B, C, H, W], the
    scale pair) on every band of the group, whatever each band was given:
    one broadcast of the scale and the shapes, then one a tensor (staged
    through the host for gloo). The bands' loaders draw the same items, but
    worker threads take the datasets' per-item draws (crops, flips,
    reversals) in the order they run, so a band's own batch may differ from
    band 0's; the group's batch must be one object."""
    src = band.ranks[0]
    band.stats["exchanges"] += 1
    head = torch.tensor([float(scale[0]), float(scale[1]), *lq.shape, *gt.shape],
                        dtype=torch.float64, device=lq.device)
    head = _stage(head, band)
    dist.broadcast(head, src=src, group=band.group)
    sh, sw, *dims = head.tolist()
    out = []
    for t, shape in ((lq, dims[:5]), (gt, dims[5:])):
        if band.first:
            buf = _stage(t, band)
            band.stats["bytes"] += buf.numel() * buf.element_size() + (
                head.numel() * head.element_size() if t is lq else 0)
        else:
            on_host = band.backend != "nccl" and t.is_cuda
            buf = torch.empty([int(d) for d in shape], dtype=t.dtype,
                              device="cpu" if on_host else t.device)
        dist.broadcast(buf, src=src, group=band.group)
        out.append(buf.to(t.device))
    return out[0], out[1], (sh, sw)


def _group_sum(t: torch.Tensor, band: BandGroup) -> torch.Tensor:
    """``t`` summed over the band group (one all-reduce, staged through the
    host for gloo), on t's device."""
    band.stats["exchanges"] += 1
    src = _stage(t, band)
    if src is t:
        src = t.clone()
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


# ---------------------------------------------------------------------------
# differentiable exchanges (the training step)
# ---------------------------------------------------------------------------


class _ExtendRows(torch.autograd.Function):
    """Each tensor's rows with ``n`` rows of the neighbouring bands on each
    side. Forward: ``neighbour_rows``. Backward: the gradient of the rows
    lent by a neighbour goes back to it, and the gradient this band's rows
    got in the neighbours' extensions is added into its edge rows; one
    exchange each way for all the tensors."""

    @staticmethod
    def forward(ctx, band, n, zeros, *tensors):
        ctx.band, ctx.n = band, n
        above, below = neighbour_rows(tensors, band, n)
        outs = []
        for i, t in enumerate(tensors):
            up = above[i] if above is not None else (t.new_zeros(t.shape[:2] + (n, t.shape[3]))
                                                      if zeros else None)
            down = below[i] if below is not None else (
                t.new_zeros(t.shape[:2] + (n, t.shape[3])) if zeros else None)
            outs.append(torch.cat([p for p in (up, t, down) if p is not None], dim=2))
        ctx.top = n if (above is not None or zeros) else 0
        ctx.bottom = n if (below is not None or zeros) else 0
        ctx.rows = [t.shape[2] for t in tensors]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        band, n, top, bottom = ctx.band, ctx.n, ctx.top, ctx.bottom
        lent = []
        for g, rows in zip(grads, ctx.rows):
            # rows 0..n: the gradient of what the band above lent (it sits
            # in this band's first `top` rows), rows n..2n: the band below's
            up = g[:, :, :n] if top else g.new_zeros(g.shape[:2] + (n, g.shape[3]))
            down = (g[:, :, top + rows:] if bottom
                    else g.new_zeros(g.shape[:2] + (n, g.shape[3])))
            lent.append(torch.cat([up, down], dim=2))
        above, below = neighbour_rows(lent, band, n)
        out = []
        for i, (g, rows) in enumerate(zip(grads, ctx.rows)):
            gi = g[:, :, top:top + rows].clone()
            if above is not None:
                gi[:, :, :n] += above[i]
            if below is not None:
                gi[:, :, rows - n:] += below[i]
            out.append(gi)
        return (None, None, None) + tuple(out)


def extend_rows_train(tensors: Sequence[torch.Tensor], band: BandGroup, n: int,
                      zeros: bool = True) -> Tuple[List[torch.Tensor], int]:
    """Differentiable: each of ``tensors`` (this band's rows, dim 2; one
    dtype) with the ``n`` rows beyond them on each side from the
    neighbours, in one exchange; at the frame's true edges ``n`` zero rows
    if ``zeros`` (a conv's zero padding), else none. Returns the extended
    tensors and how many rows came before each tensor's own."""
    outs = _ExtendRows.apply(band, n, zeros, *tensors)
    return list(outs), n if (zeros or not band.first) else 0


class _BandRowSums(torch.autograd.Function):
    """``band_row_sums``, differentiable: every band computes what follows
    from the frame's rows alike and differentiates its own share of the
    loss, so the cotangent of the frame's rows is the group's sum of the
    bands' cotangents (the same all-reduce), of which this band takes its
    rows."""

    @staticmethod
    def forward(ctx, t, band):
        ctx.band = band
        return band_row_sums(t, band)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.band.rows[ctx.band.index]
        return _group_sum(g, ctx.band)[:, :, a:b], None


def band_row_sums_train(t: torch.Tensor, band: BandGroup) -> torch.Tensor:
    """Differentiable ``band_row_sums``: the frame's per-row values [B, C,
    height] from each band's ``t`` [B, C, rows]."""
    return _BandRowSums.apply(t, band)


def _transpose_wants(band: BandGroup, owned: Sequence[Rows], wants: Sequence[Rows]):
    """For band j != this one: the rows of this band's own that j wants
    (sent forward), and the rows of this band's window that j owns
    (received forward)."""
    me, out = band.index, {}
    for j in range(band.count):
        if j != me:
            out[j] = (_clip(wants[j], *owned[me]), _clip(wants[me], *owned[j]))
    return out


class _FetchWindow(torch.autograd.Function):
    """This band's STAU window: rows ``wants[me]`` of a frame of
    ``height`` rows held in bands (``owned``), in zeros of the frame's
    height. Forward: ``fetch_rows``' sends. Backward: each band sends the
    gradient of the window rows that another band owns back to it, and adds
    what it gets into the rows it owns."""

    @staticmethod
    def forward(ctx, t, band, owned, wants, height):
        ctx.band, ctx.owned, ctx.wants = band, owned, wants
        me = band.index
        b, c, _, w = t.shape
        o0 = owned[me][0]
        pairs = _transpose_wants(band, owned, wants)
        sends = {j: t[:, :, s[0] - o0:s[1] - o0] for j, (s, _) in pairs.items() if s[0] < s[1]}
        recvs = {j: ((b, c, r[1] - r[0], w), t.dtype) for j, (_, r) in pairs.items()
                 if r[0] < r[1]}
        got = _p2p(band, sends, recvs, t.device)
        full = t.new_zeros((b, c, height, w))
        lo, hi = _clip(wants[me], *owned[me])
        if lo < hi:
            full[:, :, lo:hi] = t[:, :, lo - o0:hi - o0]
        for j, piece in got.items():
            r = pairs[j][1]
            full[:, :, r[0]:r[1]] = piece
        ctx.shape = t.shape
        return full

    @staticmethod
    def backward(ctx, g):
        band, owned, wants = ctx.band, ctx.owned, ctx.wants
        me = band.index
        b, c, rows, w = ctx.shape
        o0 = owned[me][0]
        pairs = _transpose_wants(band, owned, wants)
        sends = {j: g[:, :, r[0]:r[1]] for j, (_, r) in pairs.items() if r[0] < r[1]}
        recvs = {j: ((b, c, s[1] - s[0], w), g.dtype) for j, (s, _) in pairs.items()
                 if s[0] < s[1]}
        got = _p2p(band, sends, recvs, g.device)
        gt = g.new_zeros(ctx.shape)
        lo, hi = _clip(wants[me], *owned[me])
        if lo < hi:
            gt[:, :, lo - o0:hi - o0] = g[:, :, lo:hi]
        for j, piece in sorted(got.items()):
            s = pairs[j][0]
            gt[:, :, s[0] - o0:s[1] - o0] += piece
        return gt, None, None, None, None


def fetch_window_train(t: torch.Tensor, band: BandGroup, owned: Sequence[Rows],
                       wants: Sequence[Rows], height: int) -> torch.Tensor:
    """Differentiable: ``t`` is this band's rows ``owned[i]`` of a frame of
    ``height`` rows (dim 2), and band j's window is rows ``wants[j]``;
    returns [B, C, height, W], this band's window rows from the bands that
    hold them and zeros elsewhere (so that a sampler on the whole frame's
    grid reads, for this band's output rows, what it reads in the frame)."""
    return _FetchWindow.apply(t, band, tuple(owned), tuple(wants), height)
