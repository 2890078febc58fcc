"""TPL (temporal dependency) model — GOP-wide rate allocation.

Batched re-design of av1_tpl_setup_stats
(/root/reference/av1/encoder/tpl_model.c:1681) + the rdmult/q hooks
(av1_tpl_rdmult_setup, tpl_model.c:2405; av1_tpl_get_qstep_ratio):
estimate, per 16x16 unit of every frame in a GF group, how much future
coded quality depends on it, then (a) boost the anchor frames that are
heavily referenced and (b) scale per-block rdmult within each frame.

Design inversion: libaom runs a serial per-block mini-encoder
(mode_estimation -> tpl_model_update) with satd/subpel search; here
each frame's intra/inter costs come from one batched full-pel SSD
cost-volume pass (shared _tf-style lax.scan over offsets), and the
backward dependency propagation is a vectorized scatter over the
4 overlapped destination blocks per MV (tpl_model_update_block's
overlap-area arithmetic, tpl_model.c:328, as one np.add.at per
corner).

Outputs mirror the reference contracts:
  frame_importance[j]  -> q boost for anchors (get_q analog)
  rdmult_scale[j]      -> per-16x16 lambda multipliers (tpl_rdmult)
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

BLOCK = 16
RADIUS = 8


@lru_cache(maxsize=None)
def _cost_core(key):
    import jax
    import jax.numpy as jnp

    H, W = key
    Hb, Wb = H // BLOCK, W // BLOCK

    def fn(cur, ref):
        """cur/ref (H, W) f32 -> (intra_cost (Hb,Wb), inter_cost,
        mv (Hb,Wb,2)).  The inter cost volume comes from the SSD
        identity (ops/inter_tpu.block_cost_volume) instead of a
        289-offset shifted-plane scan."""
        from ..ops.inter_tpu import block_cost_volume
        # intra proxy: SSD vs the block DC predictor (mode_estimation's
        # best-intra cost collapses to DC on the flat/textured axis)
        blocks = cur.reshape(Hb, BLOCK, Wb, BLOCK)
        mean = blocks.mean(axis=(1, 3), keepdims=True)
        intra = ((blocks - mean) ** 2).sum(axis=(1, 3))

        ssd = block_cost_volume(cur, ref, BLOCK, RADIUS)
        side = 2 * RADIUS + 1
        flat = ssd.reshape(Hb * Wb, side * side)
        idx = jnp.argmin(flat, axis=1)
        inter = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0] \
            .reshape(Hb, Wb)
        mv = jnp.stack([idx // side - RADIUS, idx % side - RADIUS],
                       axis=-1).reshape(Hb, Wb, 2)
        return intra, inter, mv

    return fn


@lru_cache(maxsize=None)
def _cost_fn(key):
    import jax
    return jax.jit(_cost_core(key))


def _frame_costs(cur_y, ref_y):
    H = (cur_y.shape[0] // BLOCK) * BLOCK
    W = (cur_y.shape[1] // BLOCK) * BLOCK
    intra, inter, mv = _cost_fn((H, W))(
        cur_y[:H, :W].astype(np.float32),
        ref_y[:H, :W].astype(np.float32))
    from ..utils.xfer import fetch
    intra, inter, mv = fetch(intra, inter, mv)
    return intra.astype(np.float64), inter.astype(np.float64), mv


@lru_cache(maxsize=None)
def _cost_fn_batched(key):
    """Whole-group TPL pass: the UNIQUE frames ship once as a uint8
    stack and the (cur, ref) pairs are device-side indexings of it —
    the upload is O(frames), not O(pairs)."""
    import jax
    import jax.numpy as jnp
    H, W, nf, npair = key
    core = _cost_core((H, W))

    def fn(stack_u8, ci, ri):
        stack = stack_u8.astype(jnp.float32)

        def one(c, r):
            return core(stack[c], stack[r])

        return jax.vmap(one)(ci, ri)

    return jax.jit(fn)


def _group_costs(pairs):
    """pairs: list of (cur_y, ref_y) uint8 planes (same shape; numpy or
    device-resident jax).  Returns a list of (intra, inter, mv) numpy
    triples — ONE dispatch + fetch, deduplicating identical planes by
    object id (the GOP driver's device source cache makes the upload
    O(unique frames))."""
    if not pairs:
        return []
    H = (pairs[0][0].shape[0] // BLOCK) * BLOCK
    W = (pairs[0][0].shape[1] // BLOCK) * BLOCK
    uniq = {}
    planes = []
    idx = np.empty((len(pairs), 2), np.int32)
    for i, (cu, re) in enumerate(pairs):
        for j, p in enumerate((cu, re)):
            k = id(p)
            if k not in uniq:
                uniq[k] = len(planes)
                planes.append(p[:H, :W])
            idx[i, j] = uniq[k]
    if isinstance(planes[0], np.ndarray):
        stack = np.stack(planes)
        if stack.dtype != np.uint8:
            stack = stack.astype(np.float32)
    else:
        import jax.numpy as jnp
        stack = jnp.stack(planes)
        if stack.dtype != jnp.uint8:
            stack = stack.astype(jnp.float32)
    intra, inter, mv = _cost_fn_batched(
        (H, W, len(planes), len(pairs)))(stack, idx[:, 0], idx[:, 1])
    from ..utils.xfer import fetch
    intra, inter, mv = fetch(intra, inter, mv)
    return [(intra[i].astype(np.float64), inter[i].astype(np.float64),
             mv[i]) for i in range(len(pairs))]


def _propagate(dep_ref, intra, inter, mv, dep_cur):
    """tpl_model_update_block analog: each block sends
    (intra - inter)/intra * (intra + dep) to the 4 reference blocks its
    MV overlaps, weighted by overlap area."""
    Hb, Wb = intra.shape
    safe_intra = np.maximum(intra, 1.0)
    ratio = np.clip((safe_intra - np.minimum(inter, safe_intra))
                    / safe_intra, 0.0, 1.0)
    payload = ratio * (intra + dep_cur)

    ys, xs = np.mgrid[0:Hb, 0:Wb]
    ty = ys * BLOCK + mv[..., 0]
    tx = xs * BLOCK + mv[..., 1]
    b0y, b0x = ty // BLOCK, tx // BLOCK
    fy, fx = ty - b0y * BLOCK, tx - b0x * BLOCK
    for dy in (0, 1):
        for dx in (0, 1):
            wy = (BLOCK - fy) if dy == 0 else fy
            wx = (BLOCK - fx) if dx == 0 else fx
            area = (wy * wx) / float(BLOCK * BLOCK)
            by = np.clip(b0y + dy, 0, Hb - 1)
            bx = np.clip(b0x + dx, 0, Wb - 1)
            np.add.at(dep_ref, (by, bx), payload * area)


def tpl_gf_group(frames, arf_idx: int):
    """Run the TPL pass over one GF group (display order; the ARF is
    frames[arf_idx], coded first, referenced by every other frame).

    Returns (importance, rdmult_scale):
      importance: per-frame scalar >= 1 — how much the group depends on
        that frame (ARF boost driver, av1_tpl_get_qstep_ratio analog);
      rdmult_scale: per-frame (Hb, Wb) lambda multipliers < 1 on blocks
        whose quality propagates (av1_tpl_rdmult_setup_sb analog)."""
    n = len(frames)
    Hb = (frames[0][0].shape[0] // BLOCK)
    Wb = (frames[0][0].shape[1] // BLOCK)
    dep = [np.zeros((Hb, Wb)) for _ in range(n)]
    intra_all = [None] * n

    # all SSD cost volumes of the group go up in ONE device batch
    # (every pair is independent; only the dep propagation is ordered)
    pair_idx = {}
    pair_list = []

    def want(cur, ref):
        k = (cur, ref)
        if k not in pair_idx:
            pair_idx[k] = len(pair_list)
            pair_list.append((frames[cur][0], frames[ref][0]))
        return k

    for j in range(n - 1, -1, -1):
        if j == arf_idx:
            continue
        want(j, arf_idx)
        if j > 0 and (j - 1) != arf_idx:
            want(j, j - 1)
    want(arf_idx, arf_idx)
    costs = _group_costs(pair_list)

    def got(cur, ref):
        return costs[pair_idx[(cur, ref)]]

    # coding order: everyone except the ARF references it (and their
    # display predecessor); walk display order backward so dep_cur is
    # final before it is forwarded to the reference frame
    for j in range(n - 1, -1, -1):
        if j == arf_idx:
            continue
        intra, inter_a, mv_a = got(j, arf_idx)
        intra_all[j] = intra
        best_inter, best_mv, best_ref = inter_a, mv_a, arf_idx
        if j > 0 and (j - 1) != arf_idx:
            _, inter_p, mv_p = got(j, j - 1)
            use_p = inter_p < best_inter
            best_mv = np.where(use_p[..., None], mv_p, best_mv)
            best_inter = np.minimum(inter_p, best_inter)
            # propagate to whichever ref each block actually uses
            _propagate(dep[j - 1], np.where(use_p, intra, 0),
                       np.where(use_p, inter_p, 0),
                       mv_p, np.where(use_p, dep[j], 0))
            _propagate(dep[arf_idx], np.where(use_p, 0, intra),
                       np.where(use_p, 0, inter_a),
                       mv_a, np.where(use_p, 0, dep[j]))
        else:
            _propagate(dep[arf_idx], intra, inter_a, mv_a, dep[j])
    intra_all[arf_idx] = got(arf_idx, arf_idx)[0]

    importance = []
    rdmult_scale = []
    for j in range(n):
        base = np.maximum(intra_all[j], 1.0)
        beta = (base + dep[j]) / base          # >= 1
        importance.append(float(np.mean(beta)))
        # blocks that matter more get a lower lambda (finer quant)
        rdmult_scale.append(np.clip(1.0 / np.sqrt(beta), 0.5, 1.0))
    return importance, rdmult_scale


def tpl_q_offset(importance: float, qindex: int) -> int:
    """Map group dependency on a frame to a q reduction
    (av1_tpl_get_qstep_ratio + av1_get_q_index_from_qstep_ratio
    analog): qstep_new = qstep / importance^0.5, expressed in qindex
    steps (~qstep doubles every 40 qindex)."""
    if importance <= 1.0:
        return 0
    ratio = 1.0 / np.sqrt(importance)
    dq = int(round(40.0 * np.log2(ratio) / 1.0))
    return max(-60, min(0, dq))
