"""Two-level additive Schwarz preconditioner for the pressure E operator.

Counterpart of `neklab_tpu/models/precond.py`:

  P^-1 r = local(r) + coarse(r)

  * local level: "oas", overlapping Schwarz over face-neighbour patches,
    sqrt-partition-of-unity weighted on both sides, the patch inverses
    applied as one batched product; or "bj", block Jacobi: the exact
    element-diagonal blocks of E, found by probing E with the colours of
    the element graph (elements that share a DOF never share a colour, so
    no probe aliases), inverted and applied as one batched product;
  * coarse level: "q1", continuous bilinear hats on the element-corner
    vertices (2-D), E_c = P^T E P assembled exactly from the probed
    neighbour blocks; or "const", piecewise constants (any dimension),
    E_c = R E R^T probed with a distance-3 colouring. Above
    `coarse_max_dense` elements the constants are per AGGREGATE: recursive
    coordinate bisection (`mesh/re2.rcb_order`, the native library when it
    builds) groups the elements into coarse_max_dense aggregates, so the
    dense coarse inverse stays at most coarse_max_dense^2;
  * the exact neighbour-block form of E itself (eb_w, eb_nbr), probed at
    dt/g0 = 1: the pressure solver then applies E as one gather and one
    batched product. Without it the solver runs the matrix-free `e_op`.

Probing runs on the mesh's device; assembly and every inversion run on the
host in float64 (the reference inverts the block-Jacobi blocks on its
device in the mesh's dtype). As in the reference, the block-Jacobi blocks
and the constant coarse space are probed at the given dt/g0 and the OAS
patches, the Q1 coarse space and eb_w at 1 (CG does not see a constant
scale of the whole preconditioner).

Deliberate differences from the reference: `compress` defaults to False
(the reference's float32 default rests on a TPU's memory traffic); a
compressed (bfloat16) local block is promoted to the field's dtype at the
product, so the residual is never rounded to bfloat16; the block-Jacobi
blocks are built only for local="bj" (the reference builds them always and
uses them only then); the OAS weights are folded into the patch inverses.
The on-disk cache shares the mesh cache's directory under names and a
format tag of its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any

import numpy as np
import torch

from ..mesh.core import SemMesh
from . import stokes

COARSE_MAX_DENSE = 4096  # the default largest dense coarse problem
_PROBE_BYTES = 128e6  # a probe batch's pressure fields stay under this

# ---------------------------------------------------------------------------
# element graphs and colourings (host)
# ---------------------------------------------------------------------------


def _gidx_el(mesh: SemMesh) -> np.ndarray:
    return mesh.gidx.cpu().numpy().reshape(-1, mesh.nel).T  # [nel, npts]


def _shared_dofs(mesh: SemMesh):
    """(a, b, count): every pair a < b of elements that share a global DOF,
    with the number of DOFs they share."""
    g = _gidx_el(mesh)
    nel = mesh.nel
    owner = np.unique(np.stack([g.reshape(-1), np.repeat(np.arange(nel), g.shape[1])], 1),
                      axis=0)  # (dof, element) pairs, each once, sorted
    dof, el = owner[:, 0], owner[:, 1]
    starts = np.flatnonzero(np.r_[True, dof[1:] != dof[:-1]])
    mult = np.diff(np.r_[starts, len(dof)])
    keys = []
    for m in np.unique(mult[mult > 1]):
        owners = el[starts[mult == m][:, None] + np.arange(m)]  # ascending per row
        i, j = np.triu_indices(m, 1)
        keys.append((owners[:, i] * nel + owners[:, j]).reshape(-1))
    if not keys:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    key, count = np.unique(np.concatenate(keys), return_counts=True)
    return key // nel, key % nel, count


def _adjacency(nel: int, a: np.ndarray, b: np.ndarray) -> list[set[int]]:
    adj: list[set[int]] = [set() for _ in range(nel)]
    for x, y in zip(a.tolist(), b.tolist()):
        adj[x].add(y)
        adj[y].add(x)
    return adj


def element_adjacency(mesh: SemMesh) -> list[set[int]]:
    """Elements sharing any global DOF are adjacent."""
    a, b, _ = _shared_dofs(mesh)
    return _adjacency(mesh.nel, a, b)


def face_adjacency(mesh: SemMesh) -> list[set[int]]:
    """Elements sharing a FACE (>= 2 shared global DOFs in 2-D, >= 4 in 3-D)."""
    a, b, count = _shared_dofs(mesh)
    keep = count >= (2 if mesh.ndim == 2 else 4)
    return _adjacency(mesh.nel, a[keep], b[keep])


def greedy_coloring(adj: list[set[int]]) -> np.ndarray:
    n = len(adj)
    colors = -np.ones(n, dtype=np.int64)
    for v in range(n):
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def _square_adjacency(adj: list[set[int]]) -> list[set[int]]:
    """Adjacency of the squared graph (distance <= 2)."""
    out = []
    for v, nb in enumerate(adj):
        s = set(nb)
        for u in nb:
            s |= adj[u]
        s.discard(v)
        out.append(s)
    return out


# ---------------------------------------------------------------------------
# the preconditioner's data and apply
# ---------------------------------------------------------------------------


def _promote(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A stored (possibly bfloat16) matrix in the field's dtype."""
    return a if a.dtype == like.dtype else a.to(like.dtype)


@dataclasses.dataclass(frozen=True)
class ETwoLevel:
    """Preconditioner data (tensors on one device), laid out for batched
    matrix products over ELEMENT-FIRST pressure fields [nel, np2]:

    ec_inv [nc, nc]: the dense inverse of the coarse operator (Q1: nc
    vertices, q1_vert int64 [nel, 4] the corner vertex ids, q1_b4
    [np2, 4] the bilinear hats at the pressure points; const: nc
    elements, or nc aggregates with agg_of_el int64 [nel] each element's
    aggregate). Local level, one of: blocks_inv [nel, np2, np2] the
    inverse element-diagonal blocks (block Jacobi); oas_binv
    [nel, P*np2, P*np2] the patch inverses with the sqrt-partition-of-unity
    weights folded in on both sides (zero on pad slots), oas_gin int64
    [nel, P] the patch element ids, oas_rev int64 [nel, P] the flat
    (patch, slot) rows summed back into each element (pads point at a zero
    pad row). blocks_inv and oas_binv may be stored in bfloat16
    (`compress`). eb_w [nel, np2, K*np2] with eb_nbr int64 [nel, K]: the
    exact rows of E at dt/g0 = 1, (E p)_e = s * eb_w[e] @ concat_m
    p_{eb_nbr[e, m]}, or None.

    `e_apply` and `apply` take the package's element-last fields; the
    pressure solver runs its CG element-first through `e_apply_ef` and
    `apply_ef` when eb_w is attached, which saves a transposed copy per
    product.

    A rank's block of an element-partitioned run (`shard`) holds its own
    elements' rows, and its element indices (eb_nbr, oas_gin, oas_rev) point
    into [its elements, xg_n boundary slots]: the boundary elements, those
    some other rank reads, in one global order. xg_src int64 lists this
    rank's boundary elements and xg_slot their slots; part is its
    `Partition` (these four are None in one process)."""

    ec_inv: torch.Tensor
    blocks_inv: torch.Tensor | None = None
    agg_of_el: torch.Tensor | None = None
    q1_vert: torch.Tensor | None = None
    q1_b4: torch.Tensor | None = None
    eb_w: torch.Tensor | None = None
    eb_nbr: torch.Tensor | None = None
    oas_binv: torch.Tensor | None = None
    oas_gin: torch.Tensor | None = None
    oas_rev: torch.Tensor | None = None
    xg_src: torch.Tensor | None = None
    xg_slot: torch.Tensor | None = None
    xg_n: int | None = None
    part: Any = None

    def to(self, device) -> "ETwoLevel":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def _ghosted(self, p: torch.Tensor, *coarse: torch.Tensor):
        """(p with the boundary slots appended along its element axis (-2),
        the `coarse` tensors summed across the ranks): each owner writes its
        boundary elements into their slots, and one all-reduce sums the
        slots and the coarse tensors together."""
        if not self.xg_n:  # one rank: no boundary
            return p, (self.part.all_reduce_many(*coarse) if coarse else [])
        buf = p.new_zeros(p.shape[:-2] + (self.xg_n, p.shape[-1]))
        buf.index_copy_(-2, self.xg_slot, p.index_select(-2, self.xg_src))
        buf, *coarse = self.part.all_reduce_many(buf, *coarse)
        return torch.cat([p, buf], -2), coarse

    def e_apply_ef(self, p: torch.Tensor, dt_over_g0) -> torch.Tensor:
        """Exact E p on element-first fields [..., nel, np2] (needs eb_w)."""
        nel, np2 = self.eb_w.shape[:2]
        if self.part is not None:
            p = self._ghosted(p)[0]
        g = p.index_select(-2, self.eb_nbr.view(-1))  # [..., nel*K, np2]
        g = g.view(g.shape[:-2] + (nel, -1, 1))
        return dt_over_g0 * torch.matmul(self.eb_w, g).squeeze(-1)

    def _apply_ef_split(self, r: torch.Tensor) -> torch.Tensor:
        """`apply_ef` on a rank's block: the coarse residual restricted
        locally and summed in the all-reduce that fills the OAS patches'
        boundary slots (or alone, with block Jacobi); the patches' parts
        that land on other ranks' elements summed back in one more."""
        nel, np2 = r.shape
        nc = self.ec_inv.shape[0]
        rc = torch.zeros(nc, dtype=r.dtype, device=r.device)
        if self.q1_vert is not None:
            rc.index_add_(0, self.q1_vert.view(-1), (r @ self.q1_b4).view(-1))
        else:
            rc.index_add_(0, self.agg_of_el, r.sum(1))
        if self.oas_binv is not None:
            ext, (rc,) = self._ghosted(r, rc)
            rp = ext.index_select(0, self.oas_gin.view(-1)).view(nel, -1, 1)
            sol = torch.bmm(_promote(self.oas_binv, r), rp).view(-1, np2)
            sol = torch.cat([sol, sol.new_zeros(1, np2)])  # the pads' zero row
            y = sol.index_select(0, self.oas_rev.view(-1)).view(nel + self.xg_n, -1, np2).sum(1)
            out = y[:nel]
            if self.xg_n:
                back = self.part.all_reduce(y[nel:].contiguous())
                out = out.index_add(0, self.xg_src, back.index_select(0, self.xg_slot))
        else:
            (rc,) = self.part.all_reduce_many(rc)
            out = torch.bmm(_promote(self.blocks_inv, r), r.unsqueeze(-1)).squeeze(-1)
        yc = self.ec_inv @ rc
        if self.q1_vert is not None:
            return torch.addmm(out, yc.index_select(0, self.q1_vert.view(-1)).view(nel, 4),
                               self.q1_b4.T)
        return out + yc.index_select(0, self.agg_of_el)[:, None]

    def apply_ef(self, r: torch.Tensor) -> torch.Tensor:
        """P^-1 r on one element-first field [nel, np2]."""
        if self.part is not None:
            return self._apply_ef_split(r)
        nel, np2 = r.shape
        if self.oas_binv is not None:
            rp = r.index_select(0, self.oas_gin.view(-1)).view(nel, -1, 1)
            sol = torch.bmm(_promote(self.oas_binv, r), rp).view(-1, np2)
            out = sol.index_select(0, self.oas_rev.view(-1)).view(nel, -1, np2).sum(1)
        else:
            out = torch.bmm(_promote(self.blocks_inv, r), r.unsqueeze(-1)).squeeze(-1)
        if self.q1_vert is not None:
            rc = torch.zeros(self.ec_inv.shape[0], dtype=r.dtype, device=r.device)
            rc.index_add_(0, self.q1_vert.view(-1), (r @ self.q1_b4).view(-1))
            y = (self.ec_inv @ rc).index_select(0, self.q1_vert.view(-1)).view(nel, 4)
            return torch.addmm(out, y, self.q1_b4.T)
        rc = r.sum(1)
        if self.agg_of_el is None:
            return out + (self.ec_inv @ rc)[:, None]
        ra = torch.zeros(self.ec_inv.shape[0], dtype=r.dtype, device=r.device)
        ra.index_add_(0, self.agg_of_el, rc)
        return out + (self.ec_inv @ ra).index_select(0, self.agg_of_el)[:, None]

    def e_apply(self, p: torch.Tensor, dt_over_g0) -> torch.Tensor:
        """Exact E p via the neighbor-block form on element-last fields
        [..., pts2..., nel]; any leading axes."""
        nel, np2 = self.eb_w.shape[:2]
        prod, k = 1, 0
        for s in reversed(p.shape):
            prod *= int(s)
            k += 1
            if prod == np2 * nel:
                break
        if prod != np2 * nel:
            raise ValueError(f"e_apply: trailing axes of {tuple(p.shape)} do not fold "
                             f"to ({np2}, {nel})")
        pf = p.reshape(p.shape[: p.dim() - k] + (np2, nel)).transpose(-1, -2)
        return self.e_apply_ef(pf, dt_over_g0).transpose(-1, -2).reshape(p.shape)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """P^-1 r on one element-last field [pts2..., nel]."""
        return self.apply_ef(r.reshape(-1, r.shape[-1]).T).T.reshape(r.shape)

    def shard(self, part) -> "ETwoLevel":
        """This rank's block of a preconditioner built on the global mesh:
        the element-indexed arrays cut to the rank's elements, their
        neighbour indices remapped onto [its elements, the boundary slots],
        the OAS patches' reverse sum rebuilt for that layout, and the coarse
        space kept whole (its inverse is replicated; the constant coarse
        space over elements becomes one over "aggregates" of one element)."""
        local = self.oas_binv if self.oas_binv is not None else self.blocks_inv
        nel_g = local.shape[0]
        e0, e1 = part.block(nel_g)
        nl = e1 - e0
        host = lambda a: a.cpu().numpy()
        reads = [host(a) for a in (self.eb_nbr, self.oas_gin) if a is not None]
        bnd = [np.zeros(0, np.int64)]
        for r in range(part.size):  # the elements each rank reads from others
            lo, hi = r * nl, (r + 1) * nl
            for a in reads:
                seen = np.unique(a[lo:hi])
                bnd.append(seen[(seen < lo) | (seen >= hi)])
        bnd = np.unique(np.concatenate(bnd))
        mine = (bnd >= e0) & (bnd < e1)

        def ext(g):
            return np.where((g >= e0) & (g < e1), g - e0, nl + np.searchsorted(bnd, g))

        dev = local.device
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=dev)
        cut = lambda a: None if a is None else a[e0:e1].contiguous()
        kw = dict(blocks_inv=cut(self.blocks_inv), q1_vert=cut(self.q1_vert),
                  eb_w=cut(self.eb_w), oas_binv=cut(self.oas_binv))
        if self.eb_nbr is not None:
            kw["eb_nbr"] = as_t(ext(host(self.eb_nbr)[e0:e1]))
        if self.oas_gin is not None:
            gin = host(self.oas_gin)[e0:e1]
            npat = gin.shape[1]
            # slot 0 is the patch's own element; later slots naming it are pads
            valid = (np.arange(npat) == 0)[None, :] | (gin != np.arange(e0, e1)[:, None])
            tgt, rows = ext(gin)[valid], np.arange(nl * npat).reshape(nl, npat)[valid]
            order = np.argsort(tgt, kind="stable")
            tgt, rows = tgt[order], rows[order]
            cnt = np.bincount(tgt, minlength=nl + len(bnd))
            rev = np.full((nl + len(bnd), max(int(cnt.max()), 1)), nl * npat, np.int64)
            rev[tgt, np.arange(len(tgt)) - (np.cumsum(cnt) - cnt)[tgt]] = rows
            kw.update(oas_gin=as_t(ext(gin)), oas_rev=as_t(rev))
        if self.agg_of_el is not None:
            kw["agg_of_el"] = cut(self.agg_of_el)
        elif self.q1_vert is None:
            kw["agg_of_el"] = torch.arange(e0, e1, device=dev)
        return dataclasses.replace(self, **kw, xg_src=as_t(bnd[mine] - e0),
                                   xg_slot=as_t(np.flatnonzero(mine)), xg_n=len(bnd), part=part)


# ---------------------------------------------------------------------------
# probing (on the mesh's device) and assembly (host, float64)
# ---------------------------------------------------------------------------


def _probe_e_blocks(mesh: SemMesh, adj, colors3):
    """Exact neighbor-block extraction of E at dt/g0 = 1 by distance-3
    colored probing. Returns (W [nel, K, np2, np2] f64 numpy, nbr [nel, K],
    slot {(e, f): m}, nbrs lists). W is symmetrized across partner blocks."""
    np2 = int(np.prod(mesh.bm2.shape[:-1]))
    nel = mesh.nel
    nbrs = [sorted({e} | set(adj[e])) for e in range(nel)]
    K = max(len(v) for v in nbrs)
    nbr = np.zeros((nel, K), np.int64)
    for e, v in enumerate(nbrs):
        nbr[e, : len(v)] = v
        nbr[e, len(v):] = e  # pad with self (weight-zero blocks)
    slot = {}
    for e in range(nel):
        for m, f in enumerate(nbrs[e]):
            slot[(e, f)] = m

    ncol3 = int(colors3.max()) + 1
    pats = torch.eye(np2, dtype=mesh.dtype, device=mesh.device)
    cmask_all = torch.as_tensor(
        colors3[None, :] == np.arange(ncol3)[:, None], dtype=mesh.dtype, device=mesh.device
    )  # [ncol3, nel]
    outs = []
    for c in range(ncol3):
        q = pats[:, :, None] * cmask_all[c][None, None, :]  # [np2(j), np2, nel]
        out = stokes.e_op(mesh, q.reshape((np2,) + tuple(mesh.bm2.shape)), 1.0)
        outs.append(out.reshape(np2, np2, nel))
    outs = torch.stack(outs).cpu().numpy().astype(np.float64)  # one transfer

    W = np.zeros((nel, K, np2, np2))
    for c in range(ncol3):
        out = outs[c]  # out[j, i, g] = E[(g, i), (f, j)] for the color-c source f near g
        for f in np.nonzero(colors3 == c)[0]:
            for g in nbrs[f]:
                W[g, slot[(g, int(f))]] = out[:, :, g].T
    for e in range(nel):
        for m, f in enumerate(nbrs[e]):
            if f >= e:
                mt = slot[(f, e)]
                avg = 0.5 * (W[e, m] + W[f, mt].T)
                W[e, m] = avg
                W[f, mt] = avg.T
    return W, nbr, slot, nbrs


def _probe_diag_blocks(mesh: SemMesh, colors2: np.ndarray, dt_over_g0) -> np.ndarray:
    """The element-diagonal blocks of E at dt/g0, [nel, np2, np2] f64
    numpy: one probe per (colour, pattern) of the element graph's colouring,
    the patterns batched in chunks under _PROBE_BYTES (the reference's
    `probe_chunk_dev`)."""
    np2 = int(np.prod(mesh.bm2.shape[:-1]))
    nel = mesh.nel
    chunk = max(1, min(np2, int(_PROBE_BYTES / (np2 * nel * 4))))
    eye = torch.eye(np2, dtype=mesh.dtype, device=mesh.device)
    blocks = torch.zeros((nel, np2, np2), dtype=mesh.dtype, device=mesh.device)
    for c in range(int(colors2.max()) + 1):
        mask = torch.as_tensor(colors2 == c, dtype=mesh.dtype, device=mesh.device)
        for j0 in range(0, np2, chunk):
            q = eye[j0:j0 + chunk, :, None] * mask  # [m(j), np2, nel]
            m = q.shape[0]
            cols = stokes.e_op(mesh, q.reshape((m,) + tuple(mesh.bm2.shape)), dt_over_g0)
            # other colours' elements receive aliased values: masked out
            blocks[:, :, j0:j0 + m] += (cols.reshape(m, np2, nel) * mask).permute(2, 1, 0)
    return blocks.cpu().numpy().astype(np.float64)


def _invert_blocks(b: np.ndarray) -> np.ndarray:
    """Symmetrize (probing is exact, this guards roundoff), regularize (the
    all-Neumann global constant can make a block nearly singular on tiny
    meshes) and invert a batch of blocks [n, m, m], float64 on the host."""
    b = 0.5 * (b + np.swapaxes(b, 1, 2))
    tr = np.trace(b, axis1=1, axis2=2) / b.shape[-1]
    b = b + (1e-8 * np.maximum(tr, 1e-30))[:, None, None] * np.eye(b.shape[-1])[None]
    return np.linalg.inv(b)


def _dense_inverse(ec: np.ndarray, pure_neumann: bool) -> np.ndarray:
    ec = 0.5 * (ec + ec.T)
    if pure_neumann:
        # constants span the nullspace: sigma-shift so the inverse acts as a
        # bounded pseudo-inverse on it (the solver projects it out anyway)
        sigma = np.abs(np.diag(ec)).mean()
        ec = ec + sigma * np.ones_like(ec) / ec.shape[0]
    return np.linalg.inv(ec)


def _rcb_groups(mesh: SemMesh, adj, ngrp: int):
    """(group_of_el [nel], the group graph): ngrp RCB aggregates of the
    element centroids, adjacent where any of their elements are."""
    nel = mesh.nel
    xs = mesh.x.cpu().numpy().reshape(mesh.ndim, -1, nel)
    centroids = np.ascontiguousarray(xs.mean(axis=1).T)  # [nel, ndim]
    from ..mesh.re2 import rcb_order

    order = rcb_order(centroids, ngrp)
    group_of_el = np.empty(nel, dtype=np.int64)
    bounds = np.linspace(0, nel, ngrp + 1).astype(int)
    for g in range(ngrp):
        group_of_el[order[bounds[g]:bounds[g + 1]]] = g
    gadj: list[set[int]] = [set() for _ in range(ngrp)]
    for e, nb in enumerate(adj):
        ge = int(group_of_el[e])
        for u in nb:
            gu = int(group_of_el[u])
            if gu != ge:
                gadj[ge].add(gu)
    return group_of_el, gadj


def _const_coarse(mesh: SemMesh, dt_over_g0, group_of_el, gadj, colors3) -> np.ndarray:
    """E_c = R E R^T of the piecewise constants on the groups (elements or
    aggregates). The support of E R^T 1_g is g's elements and their
    neighbours; with a distance-3 colouring of the GROUP graph, same-colour
    probe supports are disjoint, so group-restricted row sums attribute
    uniquely. The colours are probed in batches under _PROBE_BYTES."""
    np2 = int(np.prod(mesh.bm2.shape[:-1]))
    nel, ngrp = mesh.nel, len(gadj)
    ncol3 = int(colors3.max()) + 1
    el_color = colors3[group_of_el]
    cmask = torch.as_tensor(el_color[None, :] == np.arange(ncol3)[:, None], dtype=mesh.dtype,
                            device=mesh.device)  # [ncol3, nel]
    chunk = max(1, int(_PROBE_BYTES / (np2 * nel * 4)))
    outs = []
    for c0 in range(0, ncol3, chunk):
        q = cmask[c0:c0 + chunk, None, :].expand(-1, np2, -1)
        k = q.shape[0]
        out = stokes.e_op(mesh, q.reshape((k,) + tuple(mesh.bm2.shape)), dt_over_g0)
        outs.append(out.reshape(k, np2, nel).sum(1))
    outs_el = torch.cat(outs).cpu().numpy().astype(np.float64)  # [ncol3, nel]
    ec = np.zeros((ngrp, ngrp))
    for c in range(ncol3):
        out = np.zeros(ngrp)
        np.add.at(out, group_of_el, outs_el[c])  # R of the probe response
        for g in np.nonzero(colors3 == c)[0]:
            for g2 in {int(g)} | gadj[g]:
                ec[g2, g] = out[g2]
    return _dense_inverse(ec, mesh.p_fixed)


def _q1_coarse(mesh: SemMesh, W, nbrs_list):
    """(ec_inv, q1_vert, b4): the Q1 vertex coarse space, E_c = P^T E P
    assembled from the probed neighbour blocks."""
    nel = mesh.nel
    g = mesh.gidx.cpu().numpy()  # [n(s), n(r), nel]
    corners = np.stack([g[0, 0], g[0, -1], g[-1, 0], g[-1, -1]], axis=1)  # [nel, 4]
    uniq, vid = np.unique(corners.reshape(-1), return_inverse=True)
    q1_vert = vid.reshape(nel, 4)
    nvert = len(uniq)
    z2 = np.asarray(mesh.basis.z2)
    hm, hp = (1.0 - z2) / 2.0, (1.0 + z2) / 2.0
    b4 = np.stack([np.outer(a, b).reshape(-1)
                   for a, b in ((hm, hm), (hm, hp), (hp, hm), (hp, hp))], axis=1)  # [np2, 4]
    ec = np.zeros((nvert, nvert))
    for e in range(nel):
        ve = q1_vert[e]
        for m, f in enumerate(nbrs_list[e]):
            blk = b4.T @ W[e, m] @ b4
            # np.add.at: periodic identification can map two corners of one
            # element to the same vertex, and fancy-indexed += drops repeats
            np.add.at(ec, (np.repeat(ve, 4), np.tile(q1_vert[f], 4)), blk.reshape(-1))
    return _dense_inverse(ec, mesh.p_fixed), q1_vert, b4


def _oas(mesh: SemMesh, W, slot):
    """(binv, gin, rev): the OAS patch inverses from the probed blocks, the
    weights folded in."""
    np2 = W.shape[-1]
    nel = mesh.nel
    fadj = face_adjacency(mesh)
    patches = [[e] + sorted(fadj[e]) for e in range(nel)]
    P = max(len(p) for p in patches)
    nb2 = P * np2
    B = np.zeros((nel, nb2, nb2))
    gin = np.zeros((nel, P), np.int64)
    win = np.zeros((nel, P))
    wsq = 1.0 / np.sqrt(np.array([1 + len(fadj[f]) for f in range(nel)], float))
    for e, pat in enumerate(patches):
        for m, g2 in enumerate(pat):
            gin[e, m] = g2
            win[e, m] = wsq[g2]
            for m2, f in enumerate(pat):
                s2 = slot.get((g2, f))
                if s2 is not None:
                    B[e, m * np2:(m + 1) * np2, m2 * np2:(m2 + 1) * np2] = W[g2, s2]
        for m in range(len(pat), P):  # identity on pad slots
            gin[e, m] = e
            sl = slice(m * np2, (m + 1) * np2)
            B[e, sl, sl] = np.eye(np2)
    binv = _invert_blocks(B)  # float64: the patch blocks are ill-conditioned
    # the weight of slot (e, m) on the way in, wsq[gin[e, m]], is also its
    # weight on the way back into element gin[e, m]: fold both into binv
    wslot = np.repeat(win, np2, axis=1)  # [nel, P*np2]
    binv = wslot[:, :, None] * binv * wslot[:, None, :]
    rev = np.zeros((nel, P), np.int64)
    for f in range(nel):
        entries = [(f, 0)] + [(g2, patches[g2].index(f)) for g2 in sorted(fadj[f])]
        for k, (g2, m) in enumerate(entries):
            rev[f, k] = g2 * P + m
        # pads: a pad slot of f's own patch, whose weighted row is zero
        rev[f, len(entries):] = f * P + len(entries)
    return binv, gin, rev


# ---------------------------------------------------------------------------
# the on-disk cache
# ---------------------------------------------------------------------------

_PC_FORMAT = "neklab_tpu_torch-pc-1"  # change when what an entry holds changes


def _pc_cache_path(mesh: SemMesh, dt_over_g0, **params) -> str | None:
    """Cache file path of a built preconditioner, keyed on the mesh's
    numerical identity (connectivity, masses, masks and the metric terms g:
    eb_w is used as the pressure operator itself), the dtype, the dt scale
    and the build parameters; None when NEKLAB_PRECOND_CACHE=0. In the mesh
    cache's directory."""
    if os.environ.get("NEKLAB_PRECOND_CACHE", "1") == "0":
        return None
    h = hashlib.sha256()
    for arr in (mesh.gidx, mesh.bm1, mesh.bm2, mesh.binv, mesh.vmask, mesh.pmask, mesh.g):
        h.update(arr.cpu().numpy().tobytes())
        h.update(str(arr.dtype).encode())
    h.update(repr((_PC_FORMAT, float(dt_over_g0), int(mesh.p_fixed),
                   sorted(params.items()))).encode())
    from ..mesh.cache import default_cache_dir

    return os.path.join(default_cache_dir(), f"pc_torch_{h.hexdigest()[:24]}.npz")


def _pc_save(path: str, pc: ETwoLevel) -> None:
    data = {"__format__": np.frombuffer(_PC_FORMAT.encode(), np.uint8)}
    for f in dataclasses.fields(pc):
        v = getattr(pc, f.name)
        if isinstance(v, torch.Tensor):
            # npz holds no bfloat16: stored as float32 with a flag
            data[f.name] = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            data[f.name + "__bf16"] = np.asarray(v.dtype == torch.bfloat16)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"
    np.savez(tmp, **data)
    os.replace(tmp, path)


def _pc_load(path: str, device) -> ETwoLevel:
    with np.load(path) as z:
        if bytes(z["__format__"]).decode() != _PC_FORMAT:
            raise ValueError(f"{path}: not a {_PC_FORMAT} entry")
        kw = {}
        for f in dataclasses.fields(ETwoLevel):
            if f.name in z.files:
                a = torch.as_tensor(z[f.name], device=device)
                kw[f.name] = a.to(torch.bfloat16) if bool(z[f.name + "__bf16"]) else a
    return ETwoLevel(**kw)


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------


def build_e_preconditioner(
    mesh: SemMesh,
    dt_over_g0: float = 1.0,
    coarse_max_dense: int = COARSE_MAX_DENSE,
    local: str | None = None,
    exact_blocks: bool | None = None,
    compress: bool | None = None,
    coarse: str | None = None,
) -> ETwoLevel:
    """Build the preconditioner on the mesh's device (cached on disk).

    dt_over_g0: the scale of the probed block-Jacobi blocks and constant
    coarse space (1 by default; CG does not see it, so one preconditioner
    serves every dt). coarse_max_dense: the largest dense coarse problem;
    larger meshes get the RCB-aggregated constant coarse space of that
    size. local: "bj" or "oas" (default: "oas" on 2-D meshes at or below
    coarse_max_dense, "bj" otherwise). exact_blocks: attach E's exact
    neighbour blocks (default: 2-D meshes at or below coarse_max_dense
    whose blocks stay under 256 MB). compress: store the local blocks in
    bfloat16 (default False; never ec_inv, whose conditioning makes
    bfloat16 rounding SPD-unsafe, nor eb_w). coarse: "q1" or "const"
    (default: "q1" on 2-D meshes at or below coarse_max_dense whose
    neighbour blocks are probed anyway, "const" otherwise).

    On a rank's block of a partitioned mesh the preconditioner is built on
    the host, from the global mesh (`Partition.global_mesh`) with the same
    defaults as in one process (or loaded from the cache), then cut to the
    block (`ETwoLevel.shard`), and only the block is moved to the rank's
    device."""
    if mesh.part is not None:
        if mesh.part.global_mesh is None:
            raise ValueError("build_e_preconditioner: a rank's block needs the global mesh "
                             "(shard it with parallel.shard_sem_mesh)")
        return build_e_preconditioner(
            mesh.part.global_mesh.to("cpu"), dt_over_g0, coarse_max_dense, local,
            exact_blocks, compress, coarse).shard(mesh.part).to(mesh.device)
    np2 = int(np.prod(mesh.bm2.shape[:-1]))
    nel, dtype, device = mesh.nel, mesh.dtype, mesh.device
    cache_path = _pc_cache_path(
        mesh, dt_over_g0, coarse_max_dense=coarse_max_dense, local=str(local),
        exact_blocks=str(exact_blocks), compress=str(compress), coarse=str(coarse))
    if cache_path is not None and os.path.exists(cache_path):
        try:
            return _pc_load(cache_path, device)
        except (OSError, ValueError, KeyError):  # corrupt or foreign: rebuild
            pass

    from .. import native

    adj = element_adjacency(mesh)
    nat = native.adjacency_colorings(_gidx_el(mesh), nel)
    colors2, colors3_nat = nat if nat is not None else (greedy_coloring(adj), None)

    small2d = mesh.ndim == 2 and nel <= coarse_max_dense
    if exact_blocks is None:
        K_est = 1 + max((len(s) for s in adj), default=0)
        exact_blocks = small2d and nel * K_est * np2 * np2 * 4 < 256e6
    if local is None:
        local = "oas" if small2d else "bj"
    if coarse is None:
        coarse = "q1" if small2d and (exact_blocks or local == "oas") else "const"
    if coarse == "q1" and not small2d:
        raise ValueError("coarse='q1' requires a 2-D mesh with nel <= coarse_max_dense "
                         f"(got ndim={mesh.ndim}, nel={nel})")

    # the groups of the constant coarse space and the element colouring of
    # the neighbour-block probing
    colors3_el = None
    if nel <= coarse_max_dense:
        group_of_el, gadj = np.arange(nel), adj
        colors3_el = colors3_nat if colors3_nat is not None else greedy_coloring(
            _square_adjacency(adj))
        colors3 = colors3_el
    else:
        group_of_el, gadj = _rcb_groups(mesh, adj, coarse_max_dense)
        colors3 = greedy_coloring(_square_adjacency(gadj))

    W = slot = nbrs_list = None
    kw = {}
    if exact_blocks or local == "oas" or coarse == "q1":
        if colors3_el is None:
            colors3_el = greedy_coloring(_square_adjacency(adj))
        W, nbr, slot, nbrs_list = _probe_e_blocks(mesh, adj, colors3_el)
        if exact_blocks:
            kw.update(eb_w=torch.as_tensor(W.transpose(0, 2, 1, 3).reshape(nel, np2, -1),
                                           dtype=dtype, device=device),  # [nel, np2, K*np2]
                      eb_nbr=torch.as_tensor(nbr, device=device))

    if coarse == "q1":
        ec_inv, q1_vert, b4 = _q1_coarse(mesh, W, nbrs_list)
        kw.update(q1_vert=torch.as_tensor(q1_vert, device=device),
                  q1_b4=torch.as_tensor(b4, dtype=dtype, device=device))
    else:
        ec_inv = _const_coarse(mesh, dt_over_g0, group_of_el, gadj, colors3)
        if len(gadj) < nel:
            kw["agg_of_el"] = torch.as_tensor(group_of_el, device=device)

    pdtype = torch.bfloat16 if compress else dtype
    as_local = lambda a: torch.as_tensor(a, dtype=dtype, device=device).to(pdtype)
    if local == "oas":
        binv, gin, rev = _oas(mesh, W, slot)
        kw.update(oas_binv=as_local(binv), oas_gin=torch.as_tensor(gin, device=device),
                  oas_rev=torch.as_tensor(rev, device=device))
    else:
        kw["blocks_inv"] = as_local(_invert_blocks(_probe_diag_blocks(mesh, colors2,
                                                                      dt_over_g0)))
    pc = ETwoLevel(ec_inv=torch.as_tensor(ec_inv, dtype=dtype, device=device), **kw)
    if cache_path is not None:
        try:
            _pc_save(cache_path, pc)
        except OSError:
            pass
    return pc
