"""f32-q paged attention against JAX's ``paged_attention`` on the CPU.

The port's ``paged_attention`` on CPU tensors runs ``paged_attention_plain``,
the page walk that the card's split-precision tiles (``csrc/
paged_attention.cu``: the decode tile at up to 16 rows a kv head, the
extend tile above) are held to; JAX's runs its Pallas kernels in interpret
mode (``_paged_dma_body`` at d 128, ``_paged_kernel`` otherwise).  f32 q
over f32, int8 and fp8 pools: the decode tile's rows (1, 4, 5, 16), the
extend tile's (17, a 64-row wave), every head dim, a window and ragged
lengths (a full table, mid-page, the chunk alone, 0, past the table).  Then
+-inf and NaN in K, in V and in a V scale, in a slot every row sees and in
a masked slot of a visited page: the NaN / inf pattern equal, the finite
values within the port's f32 gate (1e-4).  Then the tiles' rows and block
counts as ``row_tile`` and ``split_plan`` give them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.ops import paged_attention as jpa
from flashattn_tpu.ops import quant as jq
from flashattn_tpu_torch.ops import paged_attention as tpa

TOL = 1e-4

# (d, chunk, hq, hkv, page, pps, window): rows = hq / hkv * chunk
CASES = {
    "rows1_d32": (32, 1, 2, 2, 4, 3, None),
    "rows4_gqa4_d64": (64, 1, 8, 2, 8, 3, None),
    "rows5_chunk5_window6_d128": (128, 5, 2, 2, 8, 3, 6),
    "rows16_gqa16_d32": (32, 1, 16, 1, 4, 3, None),
    "rows17_chunk17_d64": (64, 17, 2, 2, 8, 4, None),
    "rows64_chunk64_d128": (128, 64, 2, 2, 16, 5, None),
    "rows64_gqa4_chunk16_window10_d32": (32, 16, 8, 2, 8, 4, 10),
}
POOLS = ["f32", "int8", "fp8"]


def _inputs(seed, d, chunk, hq, hkv, page, pps, pool, lens=None):
    """q and the pools for the port and for JAX from the same numpy draws
    (a quantized pool by JAX's quantize, its values and scales handed to
    the port).  Five sequences: a full table, a mid-page length, the chunk
    alone, length 0 and a padding length past the table's capacity."""
    rng = np.random.default_rng(seed)
    b, n_pages = 5, 5 * pps + 1
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(n_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    if lens is None:
        lens = [page * pps, page + chunk + 1, chunk, 0, page * pps + 3]
    lens = np.asarray(lens, np.int32)
    rest = (lens, table)
    if pool == "f32":
        return ([torch.from_numpy(a) for a in (q, kp, vp, *rest)], {},
                [jnp.asarray(a) for a in (q, kp, vp, *rest)], {})
    quantize = jq.quantize_int8 if pool == "int8" else jq.quantize_fp8
    tdt = torch.int8 if pool == "int8" else torch.float8_e4m3fn
    kq, vq = quantize(jnp.asarray(kp), -1), quantize(jnp.asarray(vp), -1)

    def values(t):
        return torch.from_numpy(np.array(t.values.astype(jnp.float32))).to(tdt)

    def scales(t):
        return torch.from_numpy(np.array(t.scales))

    return ([torch.from_numpy(q), values(kq), values(vq),
             *(torch.from_numpy(a) for a in rest)],
            dict(k_scales=scales(kq), v_scales=scales(vq)),
            [jnp.asarray(q), kq.values, vq.values, *(jnp.asarray(a) for a in rest)],
            dict(k_scales=kq.scales, v_scales=vq.scales))


def _match(got, want, tol=TOL):
    """NaN where JAX has NaN, the same infinities, the finite values within
    ``tol``; returns the share of non-finite elements."""
    got = got.numpy()
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    if fin.any():
        assert np.abs(got[fin] - want[fin]).max() <= tol
    return 1.0 - float(fin.mean())


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("case", list(CASES))
def test_paged_f32_matches_jax_kernel(case, pool):
    d, chunk, hq, hkv, page, pps, window = CASES[case]
    args_t, kw_t, args_j, kw_j = _inputs(31, d, chunk, hq, hkv, page, pps, pool)
    got = pt.paged_attention(*args_t, window=window, **kw_t)
    want = jpa.paged_attention(*args_j, window=window, **kw_j)
    assert _match(got, want) == 0.0


# (where, value, slot): slot "live" (position 1, seen by every row) or
# "masked" (one past sequence 0's length, in the last page its walk visits)
NONFINITE = [(w, v, s) for w in ("K", "V", "V scale")
             for v in (math.inf, -math.inf, math.nan) for s in ("live", "masked")] + [
    ("q", v, "live") for v in (math.inf, -math.inf, math.nan)]


@pytest.mark.parametrize("where,value,slot", NONFINITE)
def test_paged_f32_nonfinite_matches_jax_kernel(where, value, slot):
    """A non-finite K or V element (f32 pool), V scale (int8 and fp8 pools)
    or q element (f32 and int8 pools) reaches the outputs as in JAX's page
    walk: a live K of +-inf gives its rows NaN (the max is inf), a masked
    one nothing (its score is -1e30); a V value or V scale reaches its
    column (every column for a scale) of every row of the wave, at p = 0
    too (C8, C15); a q element its row."""
    d, chunk, hq, hkv, page, pps = 32, 4, 4, 2, 8, 3
    lens = [page * pps - 5, 12, 4, 0, page * pps + 3]
    pos = 1 if slot == "live" else lens[0]
    pools = {"V scale": ["int8", "fp8"], "q": ["f32", "int8"]}.get(where, ["f32"])
    for pool in pools:
        args_t, kw_t, args_j, kw_j = _inputs(32, d, chunk, hq, hkv, page, pps, pool,
                                             lens)
        pg, off = int(args_t[4][0, pos // page]), pos % page
        if where == "q":
            args_t[0][0, 1, hq - 1, 7] = value
            args_j[0] = jnp.asarray(args_t[0].numpy())
        elif where == "V scale":
            kw_t["v_scales"][1, pg, off] = value
            kw_j["v_scales"] = jnp.asarray(kw_t["v_scales"].numpy())
        else:
            t = args_t[1 if where == "K" else 2]
            t[1, pg, off, 7] = value
            args_j[1 if where == "K" else 2] = jnp.asarray(t.numpy())
        got = pt.paged_attention(*args_t, **kw_t)
        want = jpa.paged_attention(*args_j, **kw_j)
        share = _match(got, want)
        bad = np.asarray(~np.isfinite(np.asarray(want)))[0, :, hq // 2:]
        # sequence 0's kv head 1 holds the value: its q heads are hit
        # (a masked K is not), every other sequence untouched
        if where == "K" and slot == "masked":
            assert share == 0.0
        else:
            assert bad.any() and share > 0.0
        assert np.isfinite(np.asarray(want)[1:]).all()


@pytest.mark.parametrize("rows", [1, 4, 5, 8, 9, 16, 17, 64, 128, 129, 2048])
def test_paged_f32_tiles_and_plan(rows):
    """f32 q takes the bf16 tiles' geometry: the decode tile's 16 rows up
    to 16 rows a kv head, the extend tile's 128 above.  ``split_plan``
    splits a grid under two waves of 132 SMs into splits of at least 512
    keys near four waves, but f32 q's decode tile (two blocks an SM, three
    to six products a key) into splits of at least 256 keys near two
    waves; above 16 rows both dtypes plan alike."""
    tile = 16 if rows <= 16 else 128
    assert tpa.row_tile(rows) == tile
    for b, h_kv, pps, window in ((4, 8, 16, None), (4, 8, 64, None), (1, 8, 128, None),
                                 (4, 8, 64, 256), (6, 2, 1024, None)):
        chunk = rows
        walk = pps if window is None else min(pps, -(-(window + chunk - 1) // 128) + 1)
        blocks = b * h_kv * -(-rows // tile)
        plans = {}
        for dt in (torch.float32, torch.bfloat16):
            min_keys, waves = ((256, 2) if dt == torch.float32 and rows <= 16
                               else (512, 4))
            want = walk
            if blocks < 2 * 132:
                want = max(-(-min_keys // 128), -(-walk // -(-(waves * 132) // blocks)))
            want = max(1, min(want, walk))
            plans[dt] = tpa.split_plan(b, h_kv, rows, chunk, 128, pps, dt, window, 132)
            assert plans[dt] == (want, -(-walk // want))
        if rows > 16:
            assert plans[torch.float32] == plans[torch.bfloat16]
