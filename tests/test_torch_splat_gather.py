"""The splat path's packed-row gather and its backward, on the CPU.

``ops/rasterize.py::select_and_pack`` gathers the depth-sorted Gaussians'
rows into (T, K, 6 + C) tiles (``PackedRowGather``). Its backward reads each
tile's first ``counts[t]`` slots only and sums each Gaussian's rows in
ascending (tile, slot) order: ``packed_rows_vjp_reference`` here, the
hand-written ``csrc/packed_rows.cu`` on the card. These
tests hold the selection's layout (a tile's live slots come first, the pad
row fills the rest, also where a tile overflows and where one is empty), the
plain backward against ``jax.vjp`` of the JAX package's gather and against
float64 within ``PACKED_ROWS_TOL``, its order of addition bit for bit
against a left-to-right chain, two runs bit for bit, autograd through the
rasterizer against ``F.embedding``'s backward, and the CUDA source's own
arithmetic, built with g++ against ``tests/host_cuda/cuda_shim.h``, bit for
bit against the plain version."""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import PACKED_ROWS_TOL, TOL, host_launches

from uncertainty_nerf_gs_tpu.ops import gaussians as jg
from uncertainty_nerf_gs_tpu.ops import rasterize as jr

from uncertainty_nerf_gs_torch.ops import gaussians as tg
from uncertainty_nerf_gs_torch.ops import rasterize as tr

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "uncertainty_nerf_gs_torch" / "csrc" / "packed_rows.cu"
SHIM = REPO / "tests" / "host_cuda"
VIEWMAT = np.eye(4, dtype=np.float32)


def _scene(rng, n, w, h, spread=1.0):
    """A JAX projection of n Gaussians in front of VIEWMAT, as both packages
    take it, with opacities and a 5-channel payload."""
    means = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(1.5, 4.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    proj = jg.project_gaussians(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
                                jnp.asarray(VIEWMAT), 50.0, 50.0, w / 2, h / 2, w, h)
    opac = (rng.uniform(0.2, 0.9, n) * np.asarray(proj.compensation)).astype(np.float32)
    payload = rng.uniform(0.0, 1.0, (n, 5)).astype(np.float32)
    return proj, opac, payload


def _selection(rng, capacity=12):
    """A scene whose Gaussians crowd the left of a wide frame: tiles on the
    left overflow ``capacity``, the rightmost are empty, the rest end ragged."""
    w, h = 160, 48
    proj, opac, payload = _scene(rng, 150, w, h, spread=0.9)
    tproj = tg.Projection(*(torch.from_numpy(np.array(x)) for x in proj))
    sel = tr._selection(tproj, torch.from_numpy(opac), torch.from_numpy(payload), w, h, capacity, None)
    counts = (sel["idx_all"] < sel["n"]).sum(dim=1).to(torch.int32)
    return proj, opac, payload, w, h, sel, counts


def _jax_src(proj, opac, payload):
    """The JAX package's packed source rows (n + 1, 6 + C), pad row last,
    and the same selection's gather indices from its select_and_pack."""
    n = opac.shape[0]
    order = np.argsort(np.where(np.asarray(proj.valid), np.asarray(proj.depths), np.inf), kind="stable")
    rows = np.concatenate([np.asarray(proj.means2d)[order], np.asarray(proj.conics)[order],
                           opac[order, None], payload[order]], axis=1)
    pad = np.zeros((1, rows.shape[1]), np.float32)
    pad[0, :2] = -1e6
    return np.concatenate([rows, pad]).astype(np.float32), n


def test_live_slots_come_first(rng):
    """Every tile's first counts[t] slots hold live Gaussians (ids below n)
    and every slot after them the pad row n; one tile overflows its
    capacity, one is empty, and the counts equal the JAX package's."""
    proj, opac, payload, w, h, sel, counts = _selection(rng)
    idx, n, k = sel["idx_all"], sel["n"], sel["idx_all"].shape[1]
    slot = torch.arange(k)[None, :]
    live = slot < counts[:, None].long()
    assert bool((idx[live] < n).all()) and bool((idx[~live] == n).all())
    assert int((sel["overflows"] > 0).sum()) >= 1 and int(counts.max()) == k
    assert int((counts == 0).sum()) >= 1
    assert 0 < int(counts[(counts > 0) & (counts < k)].numel())
    want = jr.select_and_pack(proj, jnp.asarray(opac), jnp.asarray(payload), w, h, capacity=k, tile_chunk=4)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want.counts)[:sel["num_tiles"]])


def _g_packed(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("capacity", [12, 64])
def test_packed_rows_vjp_matches_jax(rng, capacity):
    """The plain backward against jax.vjp of ``packed_src[idx]`` (the JAX
    package's gather) on every Gaussian's row within PACKED_ROWS_TOL, and
    against a float64 sum; the pad row is zero (JAX's sums the pad slots)."""
    proj, opac, payload, w, h, sel, counts = _selection(rng, capacity)
    idx, n = sel["idx_all"], sel["n"]
    src, _ = _jax_src(proj, opac, payload)
    np.testing.assert_array_equal(sel["packed_src"].numpy(), src)
    g = _g_packed(rng, tuple(idx.shape) + (src.shape[1],))
    got = tr.packed_rows_vjp_reference(g, idx, counts, n)
    _, vjp = jax.vjp(lambda s: s[jnp.asarray(idx.numpy())], jnp.asarray(src))
    (want,) = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(got[:n].numpy(), np.asarray(want)[:n], **PACKED_ROWS_TOL)
    assert bool((got[n] == 0).all())
    live = (torch.arange(idx.shape[1])[None, :] < counts[:, None].long()).numpy()
    exact = np.zeros(got.shape, np.float64)
    np.add.at(exact, idx.numpy()[live], g.numpy().astype(np.float64)[live])
    exact[n] = 0.0
    np.testing.assert_allclose(got.numpy(), exact, **PACKED_ROWS_TOL)
    assert int((np.abs(exact[:n]).sum(axis=1) > 0).sum()) > 10


def test_packed_rows_vjp_order_is_fixed(rng):
    """Each row's entries are added from left to right in ascending (tile,
    slot) order, bit for bit, and two runs give the same bits."""
    _, _, _, _, _, sel, counts = _selection(rng)
    idx, n = sel["idx_all"], sel["n"]
    g = _g_packed(rng, tuple(idx.shape) + (11,))
    got = tr.packed_rows_vjp_reference(g, idx, counts, n)
    assert torch.equal(got, tr.packed_rows_vjp_reference(g, idx, counts, n))
    chain = np.zeros((n + 1, 11), np.float32)
    gn, ix = g.numpy(), idx.numpy()
    for t in range(ix.shape[0]):
        for k in range(int(counts[t])):
            chain[ix[t, k]] = chain[ix[t, k]] + gn[t, k]  # float32 adds, one at a time
    np.testing.assert_array_equal(got.numpy(), chain)


def test_packed_rows_vjp_empty_and_ragged():
    """No live slot at all, and hand-built tiles that end at 0, 1, K - 1
    and K slots with one Gaussian in every tile."""
    g = torch.ones((3, 4, 6))
    idx = torch.full((3, 4), 5, dtype=torch.int64)
    got = tr.packed_rows_vjp_reference(g, idx, torch.zeros(3, dtype=torch.int32), 5)
    assert tuple(got.shape) == (6, 6) and not got.any()
    idx = torch.tensor([[2, 5, 5, 5], [0, 2, 4, 5], [0, 1, 2, 3]])
    counts = torch.tensor([1, 3, 4], dtype=torch.int32)
    g = torch.arange(72, dtype=torch.float32).reshape(3, 4, 6)
    got = tr.packed_rows_vjp_reference(g, idx, counts, 5)
    want = torch.zeros(6, 6)
    for t, c in enumerate(counts.tolist()):
        for k in range(c):
            want[idx[t, k]] += g[t, k]
    assert torch.equal(got, want)


def test_gather_backward_matches_embedding(rng):
    """Autograd through ``select_and_pack`` and the compositor's plain
    version: the source rows' gradient equals F.embedding's backward with
    the pad row skipped (the formulation it replaced) within TOL, and every
    gradient of the Gaussians reaches them."""
    _, opac, payload, w, h, sel, counts = _selection(rng, 64)
    src = sel["packed_src"].clone().requires_grad_(True)
    twin = sel["packed_src"].clone().requires_grad_(True)
    pix = tr._tile_pixels(sel["num_tx"], sel["num_ty"], torch.device("cpu"))
    packed = tr.PackedRowGather.apply(src, sel["idx_all"], counts)
    old = F.embedding(sel["idx_all"], twin, padding_idx=sel["n"])
    assert torch.equal(packed, old)
    for p, x in ((packed, src), (old, twin)):
        img, alpha = tr.composite_tiles(p, pix, counts)
        (img.square().sum() + alpha.sum()).backward()
    np.testing.assert_allclose(src.grad.numpy(), twin.grad.numpy(), **TOL)
    assert src.grad[: sel["n"]].abs().sum() > 0 and not src.grad[sel["n"]].any()


def test_packed_rows_wrapper_refuses():
    """The card's wrapper checks dtypes, shapes and layouts before anything
    is built; nothing is cast or copied."""
    g = torch.zeros((2, 3, 7))
    idx = torch.zeros((2, 3), dtype=torch.int64)
    counts = torch.zeros(2, dtype=torch.int32)
    for args in ((g.double(), idx, counts), (g, idx.int(), counts), (g, idx, counts.long()),
                 (g.transpose(0, 1), idx, counts), (g, idx[:, :2], counts), (g[0], idx, counts),
                 (g, torch.zeros((3, 2), dtype=torch.int64).t(), counts)):
        with pytest.raises(ValueError):
            tr._check_packed_rows(*args)
    tr._check_packed_rows(g, idx, counts)
    tr._check_packed_rows(g, torch.zeros((2, 4), dtype=torch.int64)[:, :3], counts)  # rows apart


@pytest.fixture(scope="module")
def packed_rows_host(tmp_path_factory):
    """csrc/packed_rows.cu built for the host with g++: the shim for the
    CUDA runtime header, every launch run block by block by ``host_launch``
    (a block's threads as fibers that meet at ``__syncthreads`` and at each
    warp's shuffles), the harness (tests/host_cuda/packed_rows_main.inc)
    appended."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the packed-row backward's source for the host")
    text = SOURCE.read_text()
    assert "#include <cuda_runtime.h>" in text
    text = host_launches(text.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"'))
    text += '\n#include "packed_rows_main.inc"\n'
    out = tmp_path_factory.mktemp("packed_rows_host")
    (out / "packed_rows.cpp").write_text(text)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w", f"-I{SHIM}",
                    str(out / "packed_rows.cpp"), "-o", str(out / "packed_rows_host")],
                   check=True, timeout=300)
    return out / "packed_rows_host"


def test_packed_rows_sort_network_sorts(packed_rows_host):
    """The runs' bitonic network sorts every sequence of 8 and of 16 zeros
    and ones, so every sequence of 8 or 16 keys, and 200,000 random
    sequences of 32 keys as std::sort does: on the host the count kernel
    hands out a run's places in one order, on the card in any."""
    assert subprocess.run([str(packed_rows_host), "sort"], timeout=120).returncode == 0


def _built_selection(rng, case):
    """Hand-built tiles in ``select_and_pack``'s layout (rows K + 1 apart,
    each tile's ids ascending in its first counts[t] slots, the pad row n
    after them) that the scene cannot give: one Gaussian in every tile (a
    run of length T, past what a warp ranks by shuffles) beside runs of 9-32
    and short ones; no live slot at all; every tile at capacity; ids drawn
    from the even rows only, so that half the rows no slot names; and 10,000
    rows, so that the scan of the rows' counts spans three blocks (its
    look-back). Returns (idx, counts, n)."""
    tiles, capacity, n = {"every_tile": (70, 24, 60), "no_live_slot": (12, 16, 40),
                          "full_tiles": (40, 12, 30), "unnamed_rows": (50, 10, 80),
                          "scan_blocks": (20, 64, 10_000)}[case]
    buf = torch.full((tiles, capacity + 1), n, dtype=torch.int64)
    counts = torch.zeros(tiles, dtype=torch.int32)
    for t in range(tiles):
        if case == "no_live_slot":
            continue
        if case == "full_tiles":
            ids = np.sort(rng.choice(n, capacity, replace=False))
        else:
            pool = np.arange(0, n, 2) if case == "unnamed_rows" else np.arange(n)
            ids = pool[rng.random(pool.size) < (0.004 if case == "scan_blocks" else 0.15)]
            if case == "every_tile":
                ids = np.union1d(ids, [7, 40])  # row 7 and row 40 in every tile
                if t % 3 == 0:
                    ids = np.union1d(ids, [11])  # a run of 24, ranked by shuffles
            ids = ids[:capacity]
        buf[t, :ids.size] = torch.from_numpy(ids)
        counts[t] = ids.size
    return buf[:, :capacity], counts, n


@pytest.mark.parametrize("case", [12, 64, "every_tile", "no_live_slot", "full_tiles", "unnamed_rows", "scan_blocks"])
def test_packed_rows_source_matches_plain_version(rng, tmp_path, packed_rows_host, case):
    """The CUDA source's entry point (the memset, the count, the scan, the
    place and the order-and-sum kernels) run block by block on the host,
    on a scratch buffer and an output of garbage, equals the plain version
    bit for bit, the pad row and untouched rows zero included: on the
    scene's selection at capacity 12 and 64, and on hand-built tiles
    (``_built_selection``)."""
    if isinstance(case, int):
        _, _, _, _, _, sel, counts = _selection(rng, case)
        idx, n = sel["idx_all"], sel["n"]
    else:
        idx, counts, n = _built_selection(rng, case)
    width = 12
    g = _g_packed(rng, tuple(idx.shape) + (width,))
    # select_and_pack's idx_all is a slice of a buffer one slot wider: the
    # kernel reads it in place, rows idx_stride apart
    assert idx.stride() == (idx.shape[1] + 1, 1)
    np.ascontiguousarray(torch.as_strided(idx, (idx.shape[0], idx.stride(0)), idx.stride()).numpy()).tofile(
        tmp_path / "idx.bin")
    counts.numpy().tofile(tmp_path / "counts.bin")
    g.numpy().tofile(tmp_path / "g_packed.bin")
    subprocess.run([str(packed_rows_host), str(tmp_path), str(idx.shape[0]), str(idx.shape[1]),
                    str(width), str(n), str(idx.stride(0))], check=True, timeout=120)
    got = np.fromfile(tmp_path / "g_src.bin", np.float32).reshape(n + 1, width)
    want = tr.packed_rows_vjp_reference(g, idx, counts, n).numpy()
    np.testing.assert_array_equal(got, want)
    named = np.zeros(n + 1, bool)
    live = (torch.arange(idx.shape[1])[None, :] < counts[:, None]).numpy()
    named[idx.numpy()[live]] = True
    assert not got[~named].any()  # the pad row and every row no slot names
    if case == "no_live_slot":
        assert not named.any()
    else:
        assert (got[:n] != 0).any()
    if case in (12, 64, "unnamed_rows", "scan_blocks"):
        assert (~named[:n]).any()
    if case == "every_tile":
        assert (idx.numpy() == 7).sum() == idx.shape[0] == int((idx.numpy() == 40).sum())
    if case == "full_tiles":
        assert bool((counts == idx.shape[1]).all())
