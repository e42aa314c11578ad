"""The fused Adam update (K9: ``ops/adam.py``, ``csrc/adam.cu``).

On the CPU: the table planner covers every element of every tensor once,
with its group, across launches and blocks (``plan_launches`` walked as the
kernel's blocks walk it); the wrapper refuses what the kernel does not take;
``ScheduledAdam.step`` hands the kernel every group with a gradient and
the scalars its plain passes use; and the CUDA source, built with g++
against ``tests/host_cuda/cuda_shim.h`` and run through ``ScheduledAdam``
block by block on CPU tensors, equals the eight passes' arithmetic
(``_kernel_arithmetic``: ATen's foreach ops as the card runs them, lerp's
and addcmul's fused multiply-adds rounded once) bit for bit; and the
wrapper's layout check holds its table against that build's.

Marked ``card``: the kernel against the eight passes (``plain_versions()``)
on the card bit for bit over 5 updates, eagerly and replayed from a captured
CUDA graph, and the captured training step's launches. Run them on the card
without the JAX test configuration:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adam.py -m card``.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import host_launches
from uncertainty_nerf_gs_torch.engine.optimizers import OptimizerGroupConfig, ScheduledAdam, device_schedule
from uncertainty_nerf_gs_torch.ops import adam, backend
from uncertainty_nerf_gs_torch.ops.encodings import _fma_f32

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "uncertainty_nerf_gs_torch" / "csrc" / "adam.cu"
SHIM = REPO / "tests" / "host_cuda"
B1, B2 = ScheduledAdam.b1, ScheduledAdam.b2

# three groups: a warmup (lr 0 at the first update), a decay, an AdamW
GROUPS = {
    "warmup": OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=100, warmup_steps=3),
    "decay": OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=10),
    "adamw": OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, max_steps=5, weight_decay=0.1),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the test runs csrc/adam.cu")
    return torch.device("cuda")


# -- the planner ---------------------------------------------------------------


def _covered(launch: adam.Launch, specs: list[adam.TensorSpec], counts: dict, groups: dict) -> None:
    """Adds one to each element a block of ``launch`` updates, as
    csrc/adam.cu's blocks walk the table: a block's tensor is the last whose
    first block is at or before it; a scalar-only tensor (head -1) gives a
    block BLOCK_SCALARS elements, another BLOCK_VECS float4s after its head,
    and its first block the head and the tail. Records each tensor's group."""
    firsts = [row.first_block for row in launch.rows]
    assert firsts == sorted(set(firsts)) and firsts[0] == 0
    for block in range(launch.blocks):
        row = launch.rows[bisect.bisect_right(firsts, block) - 1]
        spec, chunk = specs[row.tensor], block - row.first_block
        c = counts[row.tensor]
        groups.setdefault(row.tensor, set()).add(launch.groups[row.group])
        if row.head < 0:
            c[chunk * adam.BLOCK_SCALARS:(chunk + 1) * adam.BLOCK_SCALARS] += 1
            continue
        assert 0 <= row.head <= 3 and all((a + 4 * row.head) % 16 == 0 for a in spec.addresses)
        vecs = (spec.numel - row.head) // 4
        lo, hi = chunk * adam.BLOCK_VECS, min((chunk + 1) * adam.BLOCK_VECS, vecs)
        assert lo < hi, "a block with no float4 of its tensor"
        c[row.head + 4 * lo:row.head + 4 * hi] += 1
        if chunk == 0:
            c[:row.head] += 1
            c[row.head + 4 * vecs:] += 1


def _specs(case: str) -> list[adam.TensorSpec]:
    """Tensors as the planner sees them (addresses made up, nothing
    allocated): ``nerfacto``'s 27 tensors in 3 groups, 256-byte aligned;
    ``ensemble``'s five members in 15 groups with p, m and v views of
    stacked buffers (member m at m * numel) and gradients of their own;
    ``groups``, 40 groups of one tensor; ``offsets``, sizes 1 to 4,097 and
    a grid's at every offset from 16 bytes, the four arrays' offsets equal
    or not."""
    specs = []
    base = 1 << 32

    def alloc(numel):
        nonlocal base
        at = base
        base += (4 * numel + 255) // 256 * 256 + 256
        return at

    if case in ("nerfacto", "ensemble"):
        sizes = [[3 * 2**17 * 16, 96, 16, 16, 1] * 2, [16 * 2**14 * 16, 512, 64, 64, 1, 960, 15, 64, 1,
                                                       96, 4032, 64, 4096, 64, 192, 3], [600]]
        members = 1 if case == "nerfacto" else 5
        stacked = [[[alloc(members * n) for _ in range(3)] for n in group] for group in sizes]
        for m in range(members):
            for gi, group in enumerate(sizes):
                for n, (p, mu, nu) in zip(group, stacked[gi]):
                    specs.append(adam.TensorSpec((p + 4 * m * n, alloc(n), mu + 4 * m * n, nu + 4 * m * n), n,
                                                 m * 3 + gi))
    elif case == "groups":
        for g in range(40):
            n = 1 + 97 * g
            specs.append(adam.TensorSpec(tuple(alloc(n) for _ in range(4)), n, g))
    else:
        for n in (1, 2, 3, 4, 5, 7, 8, 4097, adam.BLOCK_SCALARS * 3 + 5, 2**20 + 3):
            for off in range(4):
                specs.append(adam.TensorSpec(tuple(alloc(n) + 4 * off for _ in range(4)), n, off % 2))
            specs.append(adam.TensorSpec((alloc(n), alloc(n) + 4, alloc(n) + 8, alloc(n)), n, 2))
        specs.append(adam.TensorSpec(tuple(alloc(1) for _ in range(4)), 0, 1))  # empty: left out
    return specs


@pytest.mark.parametrize("case", ["nerfacto", "ensemble", "groups", "offsets"])
def test_plan_covers_every_element_once(case):
    """Every element of every tensor is updated by exactly one block, with
    its own group's scalars; each launch's table fits the kernel's (at most
    MAX_TENSORS tensors of MAX_GROUPS groups, in the specs' order), and
    launches are cut only where a table is full."""
    specs = _specs(case)
    launches = adam.plan_launches(specs)
    counts = {i: np.zeros(s.numel, np.int32) for i, s in enumerate(specs)}
    groups: dict[int, set] = {}
    order = []
    for launch in launches:
        assert 0 < len(launch.rows) <= adam.MAX_TENSORS and 0 < len(launch.groups) <= adam.MAX_GROUPS
        order += [row.tensor for row in launch.rows]
        _covered(launch, specs, counts, groups)
        scalars = [(None, 16, 32, 1e-15)] * (max(s.group for s in specs) + 1)
        table = adam.pack(launch, specs, scalars, B1, B2)
        assert table.num_tensors == len(launch.rows) and ctypes.sizeof(table) <= 4096
    for a, b in zip(launches, launches[1:]):
        assert len(a.rows) == adam.MAX_TENSORS or len(a.groups) == adam.MAX_GROUPS
    assert order == [i for i, s in enumerate(specs) if s.numel]
    for i, s in enumerate(specs):
        assert (counts[i] == 1).all(), f"tensor {i} of {s.numel}: elements updated {np.unique(counts[i])} times"
        assert groups.get(i, {s.group}) == {s.group}
    want = {"nerfacto": 1, "ensemble": 2, "groups": 3}.get(case)
    if want:
        assert len(launches) == want


def test_head_is_where_all_four_arrays_reach_a_float4():
    assert adam.head_of((256, 512, 1024, 4096), 8) == 0
    assert adam.head_of((260, 516, 1028, 4100), 8) == 3  # 4 bytes past: 3 scalars to the next 16
    assert adam.head_of((268, 524, 1036, 4108), 8) == 1
    assert adam.head_of((268, 524, 1036, 4108), 4) == -1  # no float4 after the head
    assert adam.head_of((256, 260, 256, 256), 1 << 20) == -1  # offsets differ: scalars only
    assert adam.blocks_of(1, -1) == 1 and adam.blocks_of(adam.BLOCK_SCALARS + 1, -1) == 2
    assert adam.blocks_of(4 * adam.BLOCK_VECS + 3, 3) == 1 and adam.blocks_of(4 * adam.BLOCK_VECS + 4, 0) == 2


# -- the wrapper's checks ------------------------------------------------------


def _update(case: str = "") -> adam.GroupUpdate:
    p = torch.zeros(4, 5)
    g, m, v = torch.ones(4, 5), torch.zeros(4, 5), torch.zeros(4, 5)
    one = torch.ones(())
    bc2, step, decay = one, one, None
    if case == "param_float64":
        p = p.double()
    elif case == "grad_float16":
        g = g.half()
    elif case == "param_not_contiguous":
        p = torch.zeros(5, 4).t()
    elif case == "exp_avg_not_contiguous":
        m = torch.zeros(4, 10)[:, ::2]
    elif case == "exp_avg_sq_shape":
        v = torch.zeros(20)
    elif case == "grad_device":
        g = g.to("meta")
    elif case == "scalar_float64":
        step = one.double()
    elif case == "scalar_two_elements":
        bc2 = torch.ones(2)
    elif case == "decay_float64":
        decay = one.double()
    return adam.GroupUpdate([p], [g], [m], [v], decay, bc2, step, 1e-15)


@pytest.mark.parametrize("case, error", [
    ("param_float64", TypeError), ("grad_float16", TypeError), ("param_not_contiguous", ValueError),
    ("exp_avg_not_contiguous", ValueError), ("exp_avg_sq_shape", ValueError), ("grad_device", ValueError),
    ("scalar_float64", ValueError), ("scalar_two_elements", ValueError), ("decay_float64", ValueError),
])
def test_update_refuses_what_the_kernel_does_not_take(case, error):
    adam.check_update([_update()])
    with pytest.raises(error):
        adam.check_update([_update(), _update(case)])


# -- ScheduledAdam's two paths -------------------------------------------------


def _state(device, member_views: bool = True):
    """``GROUPS``' param groups: the warmup group's sizes 1, 3, 5 and 4,097;
    the decay group's a grid-sized table, a (64, 63) weight and a (100, 6)
    camera table, all three (and their moments) views at odd element offsets
    into stacked buffers, as ``parallel/ensemble_parallel.py`` lays members
    out; AdamW's a (16, 6) weight, a bias, and a parameter that gets no
    gradient. Returns (groups, moments)."""
    gen = torch.Generator().manual_seed(0)
    sizes = {"warmup": [(1,), (3,), (5,), (4097,)], "decay": [(5, 2**12, 16), (64, 63), (100, 6)],
             "adamw": [(16, 6), (7,), (9,)]}
    groups, moments = [], {}
    for name, shapes in sizes.items():
        numels = [int(np.prod(s)) for s in shapes]
        stacked = member_views and name == "decay"
        if stacked:  # one buffer per array, each tensor at an odd offset
            bufs = [torch.zeros(sum(numels) + 2 * len(numels) + 1, device=device) for _ in range(3)]
            starts = np.cumsum([1] + [n + 2 for n in numels[:-1]])
        params = []
        for i, (shape, n) in enumerate(zip(shapes, numels)):
            value = torch.randn(shape, generator=gen).to(device)
            if stacked:
                p, m, v = (b[starts[i]:starts[i] + n].view(shape) for b in bufs)
                p = p.copy_(value).detach().requires_grad_(True)
            else:
                p, m, v = value.requires_grad_(True), torch.zeros_like(value), torch.zeros_like(value)
            params.append(p)
            moments[p] = {"exp_avg": m, "exp_avg_sq": v}
        groups.append(dict(params=params, name=name, config=GROUPS[name]))
    return groups, moments


def _optimizer(device, **kw) -> ScheduledAdam:
    groups, moments = _state(device, **kw)
    return ScheduledAdam(groups, moments=moments)


def _set_grads(opts, step: int) -> None:
    """The same gradients on every optimizer's parameters; the AdamW
    group's last parameter gets none. A parameter that is a view at an
    offset gets its gradient at the same offset where its index in the
    group is even (its four arrays reach a float4 together: the head), a
    gradient of its own where odd (scalars only)."""
    gen = torch.Generator().manual_seed(100 + step)
    for groups in zip(*(o.param_groups for o in opts)):
        last = len(groups[0]["params"]) - 1
        for i, ps in enumerate(zip(*(g["params"] for g in groups))):
            grad = torch.randn(ps[0].shape, generator=gen)
            for p in ps:
                if groups[0]["name"] == "adamw" and i == last:
                    p.grad = None
                elif p.storage_offset() and i % 2 == 0:
                    buf = torch.empty(p.storage_offset() + p.numel(), device=p.device)
                    p.grad = buf[p.storage_offset():].view(p.shape).copy_(grad)
                else:
                    p.grad = grad.to(p.device)


def _assert_equal(a: ScheduledAdam, b: ScheduledAdam, what: str) -> None:
    for ga, gb in zip(a.param_groups, b.param_groups):
        assert torch.equal(ga["count"], gb["count"]) and torch.equal(ga["adam_count"], gb["adam_count"])
        for pa, pb in zip(ga["params"], gb["params"]):
            for name, x, y in (("p", pa, pb), ("exp_avg", a.state[pa]["exp_avg"], b.state[pb]["exp_avg"]),
                               ("exp_avg_sq", a.state[pa]["exp_avg_sq"], b.state[pb]["exp_avg_sq"])):
                assert torch.equal(x, y), (
                    f"{what}: {ga['name']} {tuple(pa.shape)} {name} differs in "
                    f"{int((x != y).sum())} of {x.numel()}, by up to {float((x - y).abs().max()):.3g}")


def _kernel_arithmetic(opt: ScheduledAdam) -> None:
    """One update in csrc/adam.cu's arithmetic, op by op in PyTorch on the
    CPU: ATen's foreach passes as the card runs them (lerp's small-weight
    form and addcmul a fused multiply-add rounded once, ``_fma_f32``; every
    other op one IEEE rounding). The square root is numpy's in float64,
    rounded to float32 (correctly rounded: 53 >= 2 x 24 + 2 bits), since
    PyTorch's vectorised float32 sqrt on the CPU is not always."""
    def sqrt(a):
        return torch.from_numpy(np.sqrt(a.double().numpy()).astype(np.float32))

    w1, c2 = torch.tensor(1.0 - B1, dtype=torch.float32), torch.tensor(1.0 - B2, dtype=torch.float32)
    for group in opt.param_groups:
        cfg = group["config"]
        lr = device_schedule(cfg, group["count"])
        group["count"] += 1
        group["adam_count"] += 1
        t = group["adam_count"].to(torch.float32)
        bc2, step = torch.sqrt(1.0 - B2**t), lr / (1.0 - B1**t)
        for p in group["params"]:
            if p.grad is None:
                continue
            g, m, v = p.grad, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]
            with torch.no_grad():
                m.copy_(_fma_f32(w1, g - m, m))
                v.copy_(_fma_f32(c2, g * g, v * B2))
                if cfg.weight_decay:
                    p.mul_(1.0 - lr * cfg.weight_decay)
                p.sub_(m / ((sqrt(v) / bc2 + cfg.eps) / step))


def test_step_hands_the_kernel_every_group(monkeypatch):
    """With the kernel path taken (``use_kernel`` True), one ``adam_update``
    a step gets every group that has a gradient, in order, with the state's
    own moments, the decay only where the group decays, and the scalars the
    plain passes use; a parameter without a gradient is left out."""
    opt = _optimizer("cpu")
    calls = []
    monkeypatch.setattr(backend, "use_kernel", lambda t: True)
    monkeypatch.setattr(adam, "adam_update", lambda groups, b1, b2: calls.append((groups, b1, b2)))
    _set_grads([opt], 0)
    opt.step()
    (groups, b1, b2), = calls
    assert (b1, b2) == (B1, B2) and len(groups) == 3
    for grp, pg in zip(groups, opt.param_groups):
        cfg = pg["config"]
        want = [p for p in pg["params"] if p.grad is not None]
        assert grp.params == want and len(want) == len(pg["params"]) - (pg["name"] == "adamw")
        assert all(g is p.grad for g, p in zip(grp.grads, want))
        assert all(m is opt.state[p]["exp_avg"] and v is opt.state[p]["exp_avg_sq"]
                   for m, v, p in zip(grp.exp_avg, grp.exp_avg_sq, want))
        lr = device_schedule(cfg, torch.zeros((), dtype=torch.int64))
        t = torch.ones((), dtype=torch.float32)
        assert torch.equal(grp.bc2_sqrt, torch.sqrt(1.0 - B2**t)) and torch.equal(grp.step_size, lr / (1.0 - B1**t))
        assert (grp.decay is None) == (not cfg.weight_decay) and grp.eps == cfg.eps
        if cfg.weight_decay:
            assert torch.equal(grp.decay, 1.0 - lr * cfg.weight_decay)
    assert [int(g["count"]) for g in opt.param_groups] == [1, 1, 1]


@pytest.fixture(scope="module")
def adam_host(tmp_path_factory):
    """csrc/adam.cu built for the host with g++ as a shared library: the
    shim for the CUDA runtime header, the launch run block by block by
    ``host_launch`` (a block's threads as fibers), IEEE single precision
    with nothing contracted and ``__fmaf_rn`` rounded once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build csrc/adam.cu for the host")
    text = SOURCE.read_text()
    assert "#include <cuda_runtime.h>" in text
    text = host_launches(text.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"'))
    out = tmp_path_factory.mktemp("adam_host")
    (out / "adam.cpp").write_text(text)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w", "-shared", "-fPIC",
                    f"-I{SHIM}", str(out / "adam.cpp"), "-o", str(out / "libadam_host.so")],
                   check=True, timeout=300)
    return ctypes.CDLL(str(out / "libadam_host.so"))


@pytest.mark.parametrize("member_views", [True, False])
def test_source_matches_the_passes_arithmetic_on_the_host(monkeypatch, adam_host, member_views):
    """Five updates through ``ScheduledAdam.step`` on its kernel path, with
    csrc/adam.cu run on the host in place of the card (the table packed by
    ``ops/adam.py``, the launch's blocks one by one), equal
    ``_kernel_arithmetic`` bit for bit: every element of every tensor
    updated once, with its own group's lr, counts and decay."""
    def entry(library, name, argtypes, restype=ctypes.c_int):
        fn = getattr(adam_host, name)
        fn.argtypes, fn.restype = argtypes, restype
        return fn

    monkeypatch.setattr(backend, "use_kernel", lambda t: True)
    monkeypatch.setattr(backend, "entry", entry)
    monkeypatch.setattr(backend, "current_stream_handle", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(adam, "_layout_checked", False)
    kernel, want = _optimizer("cpu", member_views=member_views), _optimizer("cpu", member_views=member_views)
    before = backend.launch_counts["adam_update"]
    for step in range(5):
        _set_grads([kernel, want], step)
        kernel.step()
        _kernel_arithmetic(want)
        _assert_equal(kernel, want, f"update {step}")
    assert backend.launch_counts["adam_update"] - before == 5
    backend.launch_counts["adam_update"] = before
    frozen = kernel.param_groups[2]["params"][-1]  # never had a gradient
    assert not kernel.state[frozen]["exp_avg"].any() and not kernel.state[frozen]["exp_avg_sq"].any()


def test_layout_check_holds_the_mirror_against_the_build(monkeypatch, adam_host):
    """``_check_layout``, the one guard of the table's layout, against
    csrc/adam.cu built for the host: it passes with ``_Table`` and the
    planner's constants as they are, and raises where one of them differs
    from the source's."""
    def entry(library, name, argtypes, restype=ctypes.c_int):
        fn = getattr(adam_host, name)
        fn.argtypes, fn.restype = argtypes, restype
        return fn

    monkeypatch.setattr(backend, "entry", entry)
    monkeypatch.setattr(adam, "_layout_checked", False)
    adam._check_layout()
    assert adam._layout_checked
    for name, value in (("MAX_TENSORS", adam.MAX_TENSORS - 1), ("BLOCK_VECS", 2 * adam.BLOCK_VECS),
                        ("BLOCK_SCALARS", adam.BLOCK_SCALARS // 2)):
        with monkeypatch.context() as m:
            m.setattr(adam, name, value)
            m.setattr(adam, "_layout_checked", False)
            with pytest.raises(RuntimeError, match="table layout"):
                adam._check_layout()


# -- on the card ---------------------------------------------------------------


def _warm(device) -> None:
    """One launch on a throwaway optimizer: the library built, loaded and its
    runtime started before a capture."""
    p = torch.zeros(4, device=device, requires_grad=True)
    p.grad = torch.ones(4, device=device)
    ScheduledAdam([dict(params=[p], name="warm", config=OptimizerGroupConfig())]).step()
    torch.cuda.synchronize(device)


@pytest.mark.card
@pytest.mark.parametrize("member_views", [True, False])
def test_kernel_matches_plain_passes_on_the_card(card, member_views):
    """Five updates on the kernel path against the eight foreach passes
    (``plain_versions()``) on the same card: p, both moments and the counts
    bit for bit after each, one launch an update."""
    kernel, plain = _optimizer(card, member_views=member_views), _optimizer(card, member_views=member_views)
    _warm(card)
    for step in range(5):
        _set_grads([kernel, plain], step)
        before = backend.launch_counts["adam_update"]
        kernel.step()
        assert backend.launch_counts["adam_update"] - before == 1
        with backend.plain_versions():
            plain.step()
        assert backend.launch_counts["adam_update"] - before == 1
        torch.cuda.synchronize(card)
        _assert_equal(kernel, plain, f"update {step}")


@pytest.mark.card
def test_kernel_matches_plain_passes_under_graph_replay(card):
    """The kernel path's update captured once in a CUDA graph and replayed
    five times, each on the step's gradients copied into the captured ones,
    against five eager updates of the eight passes: bit for bit after each
    replay; the capture records one launch."""
    kernel, plain = _optimizer(card), _optimizer(card)
    _warm(card)
    _set_grads([kernel, plain], 0)
    static = [p.grad for g in kernel.param_groups for p in g["params"]]
    graph = torch.cuda.CUDAGraph()
    before = backend.launch_counts["adam_update"]
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        kernel.step()
    torch.cuda.current_stream(card).wait_stream(side)
    assert backend.launch_counts["adam_update"] - before == 1
    for step in range(5):
        _set_grads([plain], step)
        for g, p in zip(static, (p for g in plain.param_groups for p in g["params"])):
            if g is not None:
                g.copy_(p.grad)
        graph.replay()
        with backend.plain_versions():
            plain.step()
        torch.cuda.synchronize(card)
        _assert_equal(kernel, plain, f"replay {step}")


@pytest.mark.card
def test_captured_training_step_runs_the_kernel_once_a_step(card):
    """A full-width active-nerfacto trainer at 3 steps a launch (2 eager, the
    capture, 1 replay): ``adam_update`` counts one launch a step, and a
    replayed launch's device kernels hold no foreach pass: every
    ``multi_tensor_apply`` kernel is the fused one."""
    from torch.profiler import ProfilerActivity, profile

    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
    from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig

    images = np.random.default_rng(0).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    trainer = NerfactoTrainer(NerfactoConfig(num_images=4, uncertainty_channels=1), hemisphere_cameras(4, 32, 32),
                              images=images, use_camera_optimizer=True, device=card)
    backend.reset_launch_counts()
    trainer.train(3, 1024, steps_per_launch=3)
    assert backend.launch_counts["adam_update"] == 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train(3, 1024, steps_per_launch=3)
        torch.cuda.synchronize(card)
    assert backend.launch_counts["adam_update"] == 6
    names = [e.key for e in prof.key_averages() if "multi_tensor_apply" in e.key]
    assert names and all("adam_multi_tensor_apply_kernel" in n for n in names), names
