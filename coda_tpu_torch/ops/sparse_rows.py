"""Sparse top-K class-row Dirichlet posteriors, the large-C state tier
(counterpart of ``coda_tpu/ops/sparse_rows.py``).

The dense posterior is ``(H, C, C)``: 2 GB at ImageNet scale (H = 500,
C = 1000, fp32), although a labeling round touches one class row per
model. Here each class row keeps

  * its **diagonal** entry exactly (``diag``, (H, C)), the parameter the
    Beta quadrature consumes;
  * its **top-K off-diagonal** entries as values and int32 column indices
    (``vals``/``idx``, (H, C, K));
  * one **residual** mass for the untracked rest (``resid``, (H, C)),
    spread evenly over the ``C - 1 - K`` untracked columns when a dense
    row is rebuilt.

Every update conserves row mass exactly, so the diagonal and the row's
off-diagonal total — the two numbers ``dirichlet_to_beta`` reduces a row
to — stay exact up to the order of float sums.

**Parity layout** (``K >= C``): ``vals`` holds the full dense rows
(diagonal at its column), ``idx`` is the identity and ``resid`` zero.
Updates then apply the dense path's float operations to the same values,
so ``sparse:K>=C`` is bitwise the dense posterior.

Every function also takes a leading replica axis S (the seed-batched
selector's state): ``diag`` ``(S, H, C)`` and so on, with one class per
replica, ``c`` ``(S,)``. Like the dense path, :func:`scatter_row` updates
the state's tensors IN PLACE (the reference returned new arrays).

Ties: ``jax.lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order, so :func:`sparsify` takes a stable
descending sort. The order decides which slot a later insert evicts and
the summation order of :func:`row_beta`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from coda_tpu_torch.ops.beta import sparse_rows_to_beta

# elements of the posterior sorted at once by :func:`sparsify`
_SORT_ELEMS = 1 << 25


class SparseRows(NamedTuple):
    """Sparse class-row posterior state."""

    diag: torch.Tensor   # (H, C) f32 — exact diagonal concentrations
    vals: torch.Tensor   # (H, C, K) f32 — top-K off-diag (K=C: full rows)
    idx: torch.Tensor    # (H, C, K) int32 — their column indices
    resid: torch.Tensor  # (H, C) f32 — untracked off-diag mass (K=C: zero)

    @property
    def n_classes(self) -> int:
        return self.diag.shape[-1]

    @property
    def k(self) -> int:
        return self.vals.shape[-1]

    @property
    def full(self) -> bool:
        """The K = C parity layout (vals = dense rows, diagonal
        included)."""
        return self.k == self.n_classes


def parse_posterior(spec: str) -> Optional[int]:
    """``'dense'`` -> None; ``'sparse:K'`` -> K (>= 1); anything else
    raises."""
    if spec == "dense":
        return None
    if spec.startswith("sparse:"):
        try:
            k = int(spec.split(":", 1)[1])
        except ValueError:
            k = 0
        if k >= 1:
            return k
    raise ValueError(
        f"unknown posterior {spec!r} (use 'dense' or 'sparse:K' with "
        "integer K >= 1, e.g. 'sparse:32')")


def posterior_nbytes(H: int, C: int, k: Optional[int]) -> int:
    """Resident bytes of the posterior representation (the term the auto
    tier's budget charges): the dense (H, C, C) fp32 tensor, or diag +
    resid + K (value, index) pairs per row."""
    if k is None:
        return 4 * H * C * C
    return H * C * (8 + 8 * min(k, C))


def sparsify(dirichlets: torch.Tensor, k: int) -> SparseRows:
    """Compress a dense ``(..., H, C, C)`` posterior. ``k >= C`` selects
    the parity layout; otherwise the top-``k`` off-diagonal entries per
    row (lower column first among equal values) are kept exactly and the
    rest is folded into the residual, so row totals are preserved. The
    result owns its memory (updates write it in place)."""
    *lead, H, C, _ = dirichlets.shape
    diag = torch.diagonal(dirichlets, dim1=-2, dim2=-1).clone()
    if k >= C:
        idx = torch.arange(C, dtype=torch.int32, device=dirichlets.device)
        return SparseRows(
            diag=diag, vals=dirichlets.clone(),
            idx=idx.expand(*lead, H, C, C).contiguous(),
            resid=torch.zeros_like(diag))
    k = min(k, C - 1)
    eye = torch.eye(C, dtype=torch.bool, device=dirichlets.device)
    rows = dirichlets.reshape(-1, C, C)
    # the sort's values, int64 indices and masked copy are three times the
    # posterior: sort a block of models at a time (2 GB of posterior at
    # ImageNet scale would take 8 GB at once)
    step = max(1, _SORT_ELEMS // (C * C))
    vals, idx = [], []
    for h in range(0, rows.shape[0], step):
        offdiag = torch.where(eye, float("-inf"), rows[h:h + step])
        v, i = torch.sort(offdiag, dim=-1, descending=True, stable=True)
        vals.append(v[..., :k])
        idx.append(i[..., :k].to(torch.int32))
    vals = torch.cat(vals).reshape(*lead, H, C, k)
    idx = torch.cat(idx).reshape(*lead, H, C, k)
    resid = dirichlets.sum(-1) - diag - vals.sum(-1)
    return SparseRows(diag=diag, vals=vals, idx=idx, resid=resid)


def to_beta(s: SparseRows) -> tuple[torch.Tensor, torch.Tensor]:
    """``(a_cc, b_cc)`` each ``(..., H, C)`` from the compact rows."""
    return sparse_rows_to_beta(s.diag, s.vals, s.resid,
                               includes_diag=s.full)


def _take_row(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Class row ``c`` of ``t`` ``(..., H, C[, K])``: a 0-d ``c`` gives
    ``(H[, K])``; ``c`` ``(S,)`` gives ``(S, H[, K])``, replica s's row
    ``c[s]``. No host synchronisation."""
    c = c.to(torch.int64)
    if c.dim() == 0:
        return t.index_select(1, c.reshape(1)).squeeze(1)
    rep = torch.arange(c.shape[0], device=t.device)
    return t[rep, :, c]


def _even_share(r: torch.Tensor, n: float) -> torch.Tensor:
    """``r / n`` rounded as one IEEE division on every device: PyTorch's
    CUDA kernel turns a division by a host scalar into a multiplication by
    its reciprocal, an ulp away from the reference's quotient, so the
    divisor is a device tensor (``n`` rounded to ``r``'s dtype). The
    surrogate's means and the overlap re-rank's scaling divide this way
    too."""
    return r / torch.full((), n, dtype=r.dtype, device=r.device)


def _per_model(w):
    """A weight as an operand of ``(..., H)`` row leaves: a 0-d weight as
    it is, a replica's ``(S,)`` weights as ``(S, 1)``."""
    return w[..., None] if w is not None and w.dim() else w


def _put_row(t: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> None:
    """Write class row ``c`` of ``t`` IN PLACE (the inverse of
    :func:`_take_row`)."""
    c = c.to(torch.int64)
    if c.dim() == 0:
        t.index_copy_(1, c.reshape(1), v.unsqueeze(1))
    else:
        t[torch.arange(c.shape[0], device=t.device), :, c] = v


def row_beta(s: SparseRows, c: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(a_t, b_t)`` of class row ``c``: O(H·K) bytes instead of the
    dense path's (H, C, C) reduction. ``(H,)`` each, or ``(S, H)`` with a
    replica axis."""
    a_t = _take_row(s.diag, c)
    rv = _take_row(s.vals, c)
    if s.full:
        return a_t, rv.sum(-1) - a_t
    return a_t, rv.sum(-1) + _take_row(s.resid, c)


def _scatter_into_row(dcol, rv, ri, r, true_class, pred_classes, lr: float,
                      C: int, K: int, w=None):
    """The per-row scatter on compact row leaves ``(dcol (..., H), rv
    (..., H, K), ri (..., H, K), r (..., H))`` -> the same four, updated
    (the reference's float operations). ``true_class`` is 0-d or ``(S,)``
    beside ``(S, H)`` leaves. ``w`` (optional tensor; 0-d, or ``(S, 1)``
    per replica, :func:`_per_model`) scales the increment to ``lr * w``;
    ``w = 0`` inserts nothing."""
    eff = lr if w is None else lr * w
    eff_k = eff[..., None] if w is not None and w.dim() else eff
    tc = true_class.reshape(true_class.shape + (1,)).to(pred_classes.dtype)
    is_diag = pred_classes == tc                                # (..., H)
    hit = ri == pred_classes[..., None]                         # (..., H, K)
    tracked = hit & (~is_diag)[..., None]
    rv1 = rv + eff_k * tracked.to(rv.dtype)
    hit_any = hit.any(-1)

    n_untracked = C - 1 - K
    share = _even_share(r, max(n_untracked, 1))
    v_new = share + eff
    # the first smallest entry, as jnp.argmin
    m_pos = torch.argmin(rv, dim=-1)                            # (..., H)
    m_val = torch.gather(rv, -1, m_pos[..., None])[..., 0]
    miss = ((~is_diag) & (~hit_any) if n_untracked > 0
            else torch.zeros_like(is_diag))
    insert = miss & (v_new > m_val)
    if w is not None:
        insert = insert & (w > 0)
    slots = torch.arange(K, device=rv.device)
    sel = insert[..., None] & (slots == m_pos[..., None])        # (..., H, K)
    rv2 = torch.where(sel, v_new[..., None], rv1)
    ri2 = torch.where(sel, pred_classes[..., None].to(ri.dtype), ri)
    # residual: the evicted entry in, the departed share out; or the whole
    # increment when the new entry would not rank
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    r2 = r + torch.where(insert, m_val - share,
                         torch.where(miss, zero + eff, zero))
    diag1 = dcol + eff * is_diag.to(dcol.dtype)
    return diag1, rv2, ri2, r2


def scatter_row(s: SparseRows, true_class: torch.Tensor,
                pred_classes: torch.Tensor, lr: float,
                weight=None) -> SparseRows:
    """One labeling round, IN PLACE: add ``lr`` at ``(h, true_class,
    pred_classes[h])`` for every model h — the sparse form of the dense
    ``dirichlets[:, true_class, :] += lr * onehot``. ``true_class`` 0-d and
    ``pred_classes`` (H,), or ``(S,)`` and ``(S, H)`` with a replica axis.

    Tracked columns and the diagonal take the increment exactly. An
    untracked column takes its share out of the residual, adds ``lr`` and
    evicts the smallest tracked entry back into the residual — unless it
    still would not rank, and then the residual absorbs the increment.
    Returns ``s`` (its tensors updated)."""
    C, K = s.n_classes, s.k
    rv = _take_row(s.vals, true_class)                          # (..., H, K)
    dcol = _take_row(s.diag, true_class)                        # (..., H)
    weight = _per_model(weight)
    eff = lr if weight is None else lr * weight
    if s.full:
        # parity layout: the dense one-hot add at the same positions
        onehot = F.one_hot(pred_classes.to(torch.int64), C).to(rv.dtype)
        eff_k = eff[..., None] if weight is not None and weight.dim() \
            else eff
        rv1 = rv + eff_k * onehot
        tc = true_class.to(torch.int64)
        on_diag = onehot.gather(-1, tc.reshape(tc.shape + (1, 1)).expand(
            *onehot.shape[:-1], 1))[..., 0]
        _put_row(s.vals, true_class, rv1)
        _put_row(s.diag, true_class, dcol + eff * on_diag)
        return s
    ri = _take_row(s.idx, true_class)
    r = _take_row(s.resid, true_class)
    diag1, rv2, ri2, r2 = _scatter_into_row(
        dcol, rv, ri, r, true_class, pred_classes, lr, C, K, w=weight)
    _put_row(s.diag, true_class, diag1)
    _put_row(s.vals, true_class, rv2)
    _put_row(s.idx, true_class, ri2)
    _put_row(s.resid, true_class, r2)
    return s


def densify_row(s: SparseRows, c: torch.Tensor) -> torch.Tensor:
    """Dense ``(H, C)`` (or ``(S, H, C)``) rebuild of class row ``c``:
    tracked entries exact, untracked columns at the even residual share
    (what the exact pi-hat column refresh reads in sparse mode)."""
    C = s.n_classes
    rv = _take_row(s.vals, c)
    if s.full:
        return rv
    ri = _take_row(s.idx, c).to(torch.int64)
    share = _even_share(_take_row(s.resid, c), max(C - 1 - s.k, 1))
    row = share[..., None].expand(*share.shape, C).clone()
    row.scatter_(-1, ri, rv)
    cols = torch.arange(C, device=rv.device)
    tc = c.to(torch.int64).reshape(c.shape + (1, 1))
    return torch.where(cols == tc, _take_row(s.diag, c)[..., None], row)


def densify(s: SparseRows) -> torch.Tensor:
    """Full dense ``(H, C, C)`` rebuild (tests and debugging only)."""
    dev = s.diag.device
    return torch.stack([densify_row(s, torch.tensor(c, device=dev))
                        for c in range(s.n_classes)], dim=1)


def state_nbytes(s: SparseRows) -> int:
    """Resident bytes of a concrete sparse state."""
    return sum(t.numel() * t.element_size() for t in s)
