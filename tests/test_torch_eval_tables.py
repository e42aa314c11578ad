"""Parity of the port's fused-ensemble eval tables against the JAX package,
on the CPU: the int8 quantizer and the bf16 packing bit for bit, the packed
and strided lookups on float32, bf16 and int8 rows and on per-level lists
(the hybrid layout), the fold and split relayouts bit for bit against the
unfolded tables, the fused render on the hybrid layout (with and without
the proposals' anchor stride, and with mlp proposals), the fused render on
bf16 and int8 tables, and K6's CUDA source run on the host on bf16, int8
and per-level tables, bit for bit against its plain version.

Inputs are numpy-seeded. The tolerances are tests/torch_parity.py's, and
the bf16 lookup's bar ``BF16_LOOKUP_TOL`` is stated there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ensemble import (  # noqa: F401  (k6_host is a fixture)
    COPIES,
    _compare,
    _rays_in_cube,
    _run_k6_host,
    bundles,
    ensemble_pair,
    flipped_rays,
    fused_pair,
    k6_host,
)
from torch_parity import BF16_LOOKUP_TOL, TOL

from uncertainty_nerf_gs_tpu.ops import encodings as jenc
from uncertainty_nerf_gs_tpu.parallel import ensemble_fused as jef

from uncertainty_nerf_gs_torch.ops import encodings as tenc
from uncertainty_nerf_gs_torch.parallel import ensemble_fused as tef

JDTYPES = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}


def _t(x):
    return torch.from_numpy(np.array(x))


def _level_rows(rng, m, feats, sizes):
    """Per-level member-packed rows (T_l, 8, M, F) uniform in +-2, in the
    port's layout, and the same rows in the JAX layout (T_l, lanes)."""
    port = [rng.uniform(-2, 2, (s, 8, m, feats)).astype(np.float32) for s in sizes]
    lanes = -(-8 * m * feats // 128) * 128
    jax_rows = [np.pad(t.reshape(t.shape[0], -1), ((0, 0), (0, lanes - 8 * m * feats))) for t in port]
    return port, jax_rows


def _packed_forms(port_rows, jax_rows, dtype):
    """(the port's packed argument, JAX's) for ``dtype``: float32 lists, bf16
    lists, or int8's dict form (each package quantizing its own rows)."""
    tp, tj = [_t(t) for t in port_rows], [jnp.asarray(t) for t in jax_rows]
    if dtype == "bf16":
        return [t.to(torch.bfloat16) for t in tp], [t.astype(jnp.bfloat16) for t in tj]
    if dtype == "int8":
        return tenc.quantize_cell_tables_int8(tp), jenc.quantize_cell_tables_int8(tj)
    return tp, tj


def _level_bar(want: np.ndarray, levels: int, feats: int, tol: dict) -> np.ndarray:
    """atol times the largest |entry| of each level's F columns, broadcast
    over the output (M, ..., L F)."""
    scale = np.abs(want.reshape(-1, levels, feats)).max(axis=(0, 2))
    return np.repeat(scale, feats) * tol["atol"]


# -- the tables ----------------------------------------------------------------


@pytest.mark.parametrize("form", ["stacked", "per_level"])
def test_quantize_int8_matches_jax(rng, form):
    """Bit for bit, tables and per-level scales: max(max |t|, 1e-12) / 127
    in float32, round half to even, clipped to +-127; a level of zeros keeps
    its 1e-12 floor."""
    port, jrows = _level_rows(rng, 2, 2, [64, 40, 64])
    port[1][:] = 0.0
    jrows[1][:] = 0.0
    if form == "stacked":
        port, jrows = [port[0], port[2]], [jrows[0], jrows[2]]
        got = tenc.quantize_cell_tables_int8(_t(np.stack(port)))
        want = jenc.quantize_cell_tables_int8(jnp.asarray(np.stack(jrows)))
        got_tables, want_tables = list(got["tables"]), list(np.asarray(want["tables"]))
    else:
        got = tenc.quantize_cell_tables_int8([_t(t) for t in port])
        want = jenc.quantize_cell_tables_int8([jnp.asarray(t) for t in jrows])
        got_tables, want_tables = got["tables"], [np.asarray(t) for t in want["tables"]]
    assert got["scales"].dtype == torch.float32 and got["scales"].shape == (len(port),)
    for lvl, (g, w) in enumerate(zip(got_tables, want_tables)):
        assert g.dtype == torch.int8
        payload = np.asarray(w)[:, :g[0].numel()].reshape(g.shape)
        assert np.array_equal(g.numpy(), payload), lvl
        assert np.float32(got["scales"][lvl]) == np.float32(want["scales"][lvl]), lvl


def test_pack_bf16_matches_jax(rng):
    """``pack_member_cell_tables(..., dtype=bf16)`` bit for bit against the
    JAX package's (both round to nearest, ties to even), pad lanes aside."""
    m, feats, table = 3, 2, 512
    rows = rng.uniform(-2, 2, (m, 3, table * 8 * feats // 128, 128)).astype(np.float32)
    want = np.asarray(jenc.pack_member_cell_tables(jnp.asarray(rows), table, feats, dtype=jnp.bfloat16))
    got = tenc.pack_member_cell_tables(_t(rows), table, feats, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (3, table, 8, m, feats)
    got_bits = got.view(torch.int16).numpy().reshape(3, table, -1)
    assert np.array_equal(got_bits, want.view(np.int16)[:, :, :8 * m * feats])


# -- the lookups -----------------------------------------------------------------


LOOKUP_CASES = [
    # name, members, features, resolutions, sizes (a dense level's res^3, or a hashed table)
    ("hybrid_m2", 2, 2, (8, 12, 30), [512, 1728, 2048]),
    ("hybrid_m3_f1", 3, 1, (6, 20, 40), [216, 1000, 1024]),
    ("stacked_m2_f4", 2, 4, (8, 16, 32), [1024, 1024, 1024]),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", LOOKUP_CASES, ids=[c[0] for c in LOOKUP_CASES])
def test_packed_lookups_match_jax(rng, case, dtype):
    """``packed_cell_lookup`` and ``packed_cell_lookup_strided`` on per-level
    tables of each dtype against the JAX package's: float32 and int8 at TOL
    (int8 rows are exact as floats and the scale rides on the weight, so
    only the sum's order differs); bf16 at BF16_LOOKUP_TOL of each level's
    largest entry (both round the weights and products to bf16, and the sums
    round to bf16 after float32 sums taken in another order)."""
    _, m, feats, res, sizes = case
    port, jrows = _level_rows(rng, m, feats, sizes)
    tp, tj = _packed_forms(port, jrows, dtype)
    pts = rng.uniform(0, 1, (150, 3)).astype(np.float32)
    pts[:3] = [[0, 0, 0], [1, 1, 1], [-1e-7, 0.5, 1 + 1e-7]]
    want = np.asarray(jenc.packed_cell_lookup(tj, jnp.asarray(pts), res, sizes, m, feats), np.float32)
    got = tenc.packed_cell_lookup(tp, _t(pts), res, sizes, m, feats).numpy()
    pos, t = _rays_in_cube(rng, 4, 48)
    want_s = np.asarray(jenc.packed_cell_lookup_strided(tj, jnp.asarray(pos), jnp.asarray(t), res, sizes, m, feats,
                                                        stride_scale=4.0), np.float32)
    got_s = tenc.packed_cell_lookup_strided(tp, _t(pos), _t(t), res, sizes, m, feats, stride_scale=4.0).numpy()
    assert any(tenc.anchor_stride(48, r, 4.0) > 1 for r in res)
    for g, w in ((got, want), (got_s, want_s)):
        assert g.shape == w.shape
        if dtype == "bf16":
            assert (np.abs(g - w) <= _level_bar(w, len(res), feats, BF16_LOOKUP_TOL)).all()
        else:
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_fold_and_split_are_exact(rng, dtype):
    """Fold 2 and 4 (a level whose cell count 4 does not divide keeps fold
    1) and split (two parts; four parts with ``max_parts`` 4) give the
    unfolded tables' lookups bit for bit, dense and strided: both are views
    of the same rows. JAX's folded and split lookups agree with its own
    unfolded ones within TOL."""
    m, feats, res, sizes = 2, 2, (8, 12, 30), [512, 1728, 2048]
    port, jrows = _level_rows(rng, m, feats, sizes)
    tp, tj = _packed_forms(port, jrows, dtype)
    pts = _t(rng.uniform(0, 1, (120, 3)).astype(np.float32))
    pos, t = (_t(a) for a in _rays_in_cube(rng, 3, 64))
    base = tenc.packed_cell_lookup(tp, pts, res, sizes, m, feats)
    base_s = tenc.packed_cell_lookup_strided(tp, pos, t, res, sizes, m, feats)
    tables = tp["tables"] if isinstance(tp, dict) else tp
    level_bytes = [x.numel() * x.element_size() for x in tables]
    variants = {
        "fold2": tenc.fold_packed_tables(tp, 2),
        "fold4": tenc.fold_packed_tables(tp, 4),
        "split2": tenc.split_packed_tables(tp, max_bytes=0.6 * max(level_bytes)),
        "split4": tenc.split_packed_tables(tp, max_bytes=0.3 * max(level_bytes), max_parts=4),
    }
    assert [x.dim() for x in variants["fold4"]["tables"]] == [5, 5, 5]
    assert isinstance(variants["split2"]["tables"][2], tuple)
    assert len(variants["split4"]["tables"][2]) == 4
    for name, packed in variants.items():
        assert torch.equal(tenc.packed_cell_lookup(packed, pts, res, sizes, m, feats), base), name
        assert torch.equal(tenc.packed_cell_lookup_strided(packed, pos, t, res, sizes, m, feats), base_s), name
    jbase = np.asarray(jenc.packed_cell_lookup(tj, jnp.asarray(pts.numpy()), res, sizes, m, feats), np.float32)
    for jpacked in (jenc.fold_packed_tables(tj, 2, 3),
                    jenc.split_packed_tables(tj, 3, real_lanes=8 * m * feats, max_bytes=1e4)):
        got = np.asarray(jenc.packed_cell_lookup(jpacked, jnp.asarray(pts.numpy()), res, sizes, m, feats),
                         np.float32)
        np.testing.assert_allclose(got, jbase, **TOL)


# -- the fused render ------------------------------------------------------------


HYBRID = dict(grid_layout="hybrid", num_proposal_samples=(64, 24), proposal_net_args=(
    dict(num_levels=2, max_res=8, log2_hashmap_size=9, hidden_dim=16),
    dict(num_levels=3, max_res=32, log2_hashmap_size=9, hidden_dim=16)))
MLP_PROPOSALS = dict(grid_layout="hybrid", proposal_field_type="mlp")


@pytest.mark.parametrize("case", ["hybrid_stride", "hybrid_exact", "hybrid_mlp_proposals"])
def test_fused_render_hybrid_matches_jax(rng, case):
    """The fused render of three hybrid members against JAX's jitted one on
    float32 tables: with the proposals' anchor stride engaged, without it,
    and with mlp proposals (the whole proposal field run member by member);
    every output within its OUTPUT_TOLS / MOMENT_TOL entry on rays whose
    shared chain's lookups flipped no cell."""
    over = MLP_PROPOSALS if case == "hybrid_mlp_proposals" else HYBRID
    jmodel, tmodel, stacked, tstacked = ensemble_pair(**over)
    enc = tmodel.field.encoding
    assert any(enc.is_dense) and not all(enc.is_dense)
    jb, tb = bundles(rng)
    want, got, j_sdist, t_sdist = fused_pair(jmodel, tmodel, stacked, tstacked, jb, tb,
                                             proposal_anchor_stride=case != "hybrid_exact")
    assert want["accumulation"].mean() > 0.01  # not an empty field
    _compare(want, got, flipped_rays(jmodel, tmodel, jb, tb, [j_sdist], [t_sdist]))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_fused_render_table_dtypes_match_jax(rng, dtype):
    """The fused render on bf16 and int8 tables (the hybrid layout, three
    members, the anchor stride engaged) against the JAX package's eager one
    on the same dtype: every output within OUTPUT_TOLS / MOMENT_TOL on rays
    whose shared chain flipped no cell (tests/torch_parity.py says why the
    jitted render is not the reference here). The JAX package's own oracles
    (tests/test_ensemble_fused.py:368, 381, 452) hold too: each dtype's rgb
    within 0.02 (bf16) or 0.05 (int8) of the float32 render, at the flax
    init scale those oracles use."""
    jmodel, tmodel, stacked, tstacked = ensemble_pair(**HYBRID)
    jb, tb = bundles(rng)
    want, got, j_sdist, t_sdist = fused_pair(jmodel, tmodel, stacked, tstacked, jb, tb, table_dtype=dtype,
                                             jit=False)
    _compare(want, got, flipped_rays(jmodel, tmodel, jb, tb, [j_sdist], [t_sdist]))
    # the JAX package's own oracles, on the port, at flax's init scale
    small = {k: v * (1e-4 / 2.0) if "encoding" in k else v for k, v in tstacked.items()}
    render = tef.build_fused_ensemble_render(tmodel)
    ref = render(small, tef.pack_ensemble_tables(tmodel, small), tb)
    low = render(small, tef.pack_ensemble_tables(tmodel, small, table_dtype=dtype), tb)
    assert float((low["rgb"] - ref["rgb"]).abs().max()) < (0.02 if dtype == "bf16" else 0.05)


# -- K6's source on the host ----------------------------------------------------


K6_TABLE_CASES = [
    # name, members, features, dtype, hybrid
    ("hybrid_f32_m2", 2, 2, "f32", True),
    ("hybrid_bf16_m2", 2, 2, "bf16", True),
    ("hybrid_int8_m2", 2, 2, "int8", True),
    ("bf16_m5_f1", 5, 1, "bf16", False),
    ("int8_m1_f1_word_copies", 1, 1, "int8", True),  # 8-byte rows: copied word by word
    ("int8_m3_f1_word_copies", 3, 1, "int8", False),  # 24-byte rows
    ("int8_m3_f4", 3, 4, "int8", True),
]


@pytest.mark.parametrize("copies", list(COPIES))
@pytest.mark.parametrize("case", K6_TABLE_CASES, ids=[c[0] for c in K6_TABLE_CASES])
def test_k6_source_on_table_dtypes_matches_plain_version(k6_host, tmp_path, rng, case, copies):
    """K6's CUDA source, run on the CPU, on per-level (hybrid) tables and on
    bf16 and int8 rows (int8 rows of 8 and 24 bytes, which the copy engine
    does not take, copied by the lanes), dense and strided, equals
    ``packed_cell_lookup_reference`` and its strided version bit for bit."""
    _, m, feats, dtype, hybrid = case
    res = (8, 12, 30, 45)
    sizes = [r**3 if hybrid and tenc.hybrid_is_dense(r, 2048) else 2048 for r in res]
    port, _ = _level_rows(rng, m, feats, sizes)
    tables, scales = [_t(t) for t in port], None
    if dtype == "bf16":
        tables = [t.to(torch.bfloat16) for t in tables]
        host = [t.view(torch.int16).numpy() for t in tables]
    elif dtype == "int8":
        q = tenc.quantize_cell_tables_int8(tables)
        tables, scales = q["tables"], q["scales"]
        host = [t.numpy() for t in tables]
    else:
        host = [t.numpy() for t in tables]
    kind = {"f32": np.float32, "bf16": "bf16", "int8": np.int8}[dtype]
    sc = None if scales is None else scales.numpy()
    pts = rng.uniform(0, 1, (130, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [-1e-7, 0.5, 1 + 1e-7]]
    got = _run_k6_host(k6_host[copies], tmp_path, host, pts, res, scales=sc, dtype=kind)
    want = tenc.packed_cell_lookup_reference(tables, _t(pts), res, sizes, scales).numpy()
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} features differ"
    pos, t = _rays_in_cube(rng, 3, 96)
    strides = [tenc.anchor_stride(96, r) for r in res]
    got = _run_k6_host(k6_host[copies], tmp_path, host, pos, res, t, strides, scales=sc, dtype=kind)
    want = tenc.packed_cell_lookup_strided_reference(tables, _t(pos), _t(t), res, sizes, strides, scales).numpy()
    assert np.array_equal(got, want.reshape(got.shape)), f"{int((got != want.reshape(got.shape)).sum())} differ"
