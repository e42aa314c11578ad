"""Training loop and rendering for the nerfacto family.

Counterpart of ``NerfactoTrainer`` in
``uncertainty_nerf_gs_tpu/engine/trainer.py``: per step a batch of rays is
drawn from the images on the device, rays are generated inside the loss so
that the camera optimizer's pose tangents receive gradients, the model's
training forward and ``nerfacto_loss`` run with autograd, and one
``ScheduledAdam`` with a param group per label (``engine/optimizers.py``)
updates the weights. ``render_image`` renders a full image in chunks with
the eval forward and ignores the pose tangents, as the JAX package does.

One step function, ``_device_step``, serves every path. It reads nothing
back to the host: the step counter, the proposal anneal, the groups' lr and
Adam's counts are tensors on the device, and the losses stay there.
``steps_per_launch = 1`` runs it eagerly, one host read of the losses a
step. ``steps_per_launch = K > 1`` is the counterpart of the JAX package's
one-launch ``lax.scan``: on the card the step is captured once into a
``torch.cuda.CUDAGraph`` (after ``WARMUP_STEPS`` eager steps on a side
stream, as PyTorch's graph rules ask) and replayed, each replay's losses
copied into row i of a (K, n_losses) device buffer that is read once a
launch; on the CPU the same function runs K times in a loop without host
reads. The trainer's generator is registered with the graph, so replays
draw what eager steps would, and a replay adds the captured step's kernel
launches to ``ops.backend``'s counters. Both give the same bits.

``gradient_checkpointing`` recomputes the model's forward in the backward
(``torch.utils.checkpoint``, non-reentrant, the JAX package's
``jax.checkpoint``). The forward's draws are taken before it, and its
dropout masks are drawn once and replayed on the recompute
(``ops.mlp.ReplayDropout``), so both runs see the same numbers.

The batch, the forward's draws and, with ``dropout_rate > 0``
(nerfacto-mcdropout), the dropout masks come from the trainer's own
``torch.Generator`` (seeded ``seed + 1``; the weights' from ``seed``), so
they are not the JAX package's numbers; the parity tests inject those. Its
state is part of ``state_dict``, so a restored trainer repeats a step bit
for bit. Unlike the JAX trainer, whose ``train`` restarts its key at ``seed
+ 1`` on every call, the generator carries on from call to call.

``face_consistency_mult > 0`` adds the JAX trainer's face-consistency loss
(``encoding_face_loss``) on the cell and hybrid layouts (the corner layout
shares its corners by construction): the mean of ``ops/encodings.py::
face_consistency_loss`` over the main field's cell-stored levels (every
level of the cell layout, the hashed levels of the hybrid one), its
vertices drawn from the trainer's generator after the forward's draws (or
given as ``draws["face_vertices"]``), so that a captured step replays them.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays, pixel_grid
from uncertainty_nerf_gs_torch.engine.optimizers import (
    OptimizerGroupConfig,
    apply_updates,
    make_optimizer,
)
from uncertainty_nerf_gs_torch.models.nerfacto import (
    NerfactoConfig,
    NerfactoModel,
    nerfacto_loss,
    proposal_anneal_factor,
)
from uncertainty_nerf_gs_torch.ops import backend
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.ops.encodings import face_lanes, face_vertices
from uncertainty_nerf_gs_torch.ops.mlp import Dropout, ReplayDropout
from uncertainty_nerf_gs_torch.utils.tracing import span

# eager steps before the first capture of a step into a CUDA graph
WARMUP_STEPS = 2


class _CapturedStep(NamedTuple):
    """One training step captured into a CUDA graph: ``losses`` is the
    graph's output buffer, ``launches`` the kernel launches a replay
    makes."""

    graph: torch.cuda.CUDAGraph
    losses: torch.Tensor
    launches: dict[str, int]


def encoding_face_loss(model: NerfactoModel, vertices: list[torch.Tensor]) -> torch.Tensor:
    """The JAX trainer's ``_encoding_face_loss``: the mean of the
    face-consistency penalty over the main field's cell-stored levels
    (``cell_levels()``: every level of the cell layout, the hashed levels of
    the hybrid one, whose dense levels share corners exactly), ``vertices``
    one (K, 3) draw a level. The features of every level are read by one
    index into the stacked ``cells``, so that the backward writes their
    gradient in one sorted accumulation."""
    enc = model.field.encoding
    levels = enc.cell_levels()
    # a level of res < 2 has no interior vertex: its term is 0, as in JAX
    live = [(j, lvl, v) for j, (lvl, v) in enumerate(zip(levels, vertices)) if int(enc.resolutions[lvl]) >= 2]
    if not live:
        return next(model.parameters()).new_zeros(())
    per_level = enc.cells[0].numel()
    lanes = torch.stack([face_lanes(v, int(enc.resolutions[lvl]), enc.table_size, enc.features_per_level)
                         + j * per_level for j, lvl, v in live])
    vals = enc.cells.reshape(-1)[lanes]  # (levels, 8, K, F)
    terms = torch.mean(torch.var(vals, dim=1, correction=0), dim=(1, 2))
    return sum(terms[i] for i in range(len(live))) / len(levels)


class NerfactoTrainer:
    """Owns the model, the cameras, the images and the optimizer on one
    device.

    Args:
      config: model config.
      cameras: the scene's cameras (moved to ``device``).
      images: (N, H, W, 3) float32 in [0, 1], one per camera; ``None``
        builds a trainer that only renders.
      seed: seeds the ``torch.Generator`` of the initial weights; ``seed +
        1`` seeds the batches and draws.
      use_camera_optimizer: adds ``camera_opt``, an (N, 6) SO3xR3 pose
        tangent leaf starting at zero, as its own param group.
      optimizer_groups: per-group configs (``DEFAULT_GROUPS`` if None).
      masks: (N, H, W) bool, True for pixels the sampler may draw.
      gradient_checkpointing: recompute the forward in the backward.
      device: ``None`` is the card; raises when there is none.
    """

    def __init__(
        self,
        config: NerfactoConfig,
        cameras: Cameras,
        images: np.ndarray | None = None,
        seed: int = 0,
        use_camera_optimizer: bool = False,
        optimizer_groups: Mapping[str, OptimizerGroupConfig] | None = None,
        masks: np.ndarray | None = None,
        gradient_checkpointing: bool = False,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.cameras = cameras.to(self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = NerfactoModel(config, device=self.device, generator=generator)
        self.model.eval()
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.images = (
            None if images is None
            else torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        )
        self._valid_coords = None
        if masks is not None:
            # the valid (cam, y, x) triples; masked sampling draws uniformly
            # from them, as nerfstudio's PixelSampler does
            valid = torch.nonzero(torch.as_tensor(np.asarray(masks, bool), device=self.device))
            if valid.shape[0] == 0:
                raise ValueError("masks exclude every pixel")
            self._valid_coords = valid
        self.camera_opt = (
            torch.zeros((len(cameras), 6), device=self.device, requires_grad=True)
            if use_camera_optimizer else None
        )
        self.optimizer_groups = optimizer_groups
        self.optimizer = make_optimizer(self.params(), optimizer_groups)
        self.gradient_checkpointing = gradient_checkpointing
        # the step on the host, and on the device for the captured step
        self.step = 0
        self._step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self._loss_names: list[str] | None = None
        self._graphs: dict[int, _CapturedStep] = {}  # rays a batch -> captured step
        # held around each launch by ``train``: a live viewer renders under
        # the same lock, so that no render joins or breaks a graph's capture
        self.launch_lock = contextlib.nullcontext()

    def params(self) -> dict[str, torch.Tensor]:
        """Every trained leaf by name: the model's state-dict names, and
        ``camera_opt`` with the camera optimizer."""
        params = dict(self.model.named_parameters())
        if self.camera_opt is not None:
            params["camera_opt"] = self.camera_opt
        return params

    # --------------------------------------------------------------- resume
    def state_dict(self) -> dict[str, Any]:
        """Resumable training state: ``params`` (detached views, by name),
        ``opt_state`` (per group the Adam count and the schedule's count;
        per parameter Adam's first and second moments, zeros before the
        first step), ``step`` and ``generator`` (the batches', draws' and
        dropout masks' generator state)."""
        params = self.params()
        groups = {}
        for group in self.optimizer.param_groups:
            groups[group["name"]] = {
                "adam_count": int(group["adam_count"]),
                "schedule_count": int(group["count"]),
            }
        moments: dict[str, dict[str, torch.Tensor]] = {"exp_avg": {}, "exp_avg_sq": {}}
        for name, p in params.items():
            for key, out in moments.items():
                out[name] = self.optimizer.state[p][key].detach()
        return {
            "params": {k: v.detach() for k, v in params.items()},
            "opt_state": {"groups": groups, **moments},
            "step": self.step,
            "generator": self._generator.get_state(),
        }

    def restore(self, ckpt: Mapping[str, Any]) -> None:
        """Load ``state_dict()`` output (or ``interop.trainer_state_from_jax``
        of the JAX trainer's). ``params`` holds every parameter (e.g.
        ``interop.params_from_jax`` of a flax tree, plus ``camera_opt`` with
        the camera optimizer); without ``opt_state`` the Adam state starts
        fresh, without ``step`` at 0, and without ``generator`` the
        generator goes on from where it is. A captured step is dropped: the
        next launch captures one again."""
        params = {k: torch.as_tensor(v) for k, v in ckpt["params"].items()}
        camera_opt = params.pop("camera_opt", None)
        if (camera_opt is None) != (self.camera_opt is None):
            raise ValueError("camera_opt must be in params exactly when the camera optimizer is on")
        self.model.load_state_dict(params, strict=True)
        with torch.no_grad():
            if camera_opt is not None:
                self.camera_opt.copy_(camera_opt)
        self._graphs.clear()
        self.optimizer = make_optimizer(self.params(), self.optimizer_groups)
        opt_state = ckpt.get("opt_state")
        if opt_state is not None:
            for group in self.optimizer.param_groups:
                counts = opt_state["groups"][group["name"]]
                group["count"].fill_(int(counts["schedule_count"]))
                group["adam_count"].fill_(int(counts["adam_count"]))
            with torch.no_grad():
                for name, p in self.params().items():
                    for key in ("exp_avg", "exp_avg_sq"):
                        self.optimizer.state[p][key].copy_(torch.as_tensor(opt_state[key][name]))
        self.step = int(ckpt.get("step", 0))
        self._step_t.fill_(self.step)
        if ckpt.get("generator") is not None:
            self._generator.set_state(ckpt["generator"])

    # ------------------------------------------------------------------ data
    def sample_batch(self, num_rays: int, generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """Uniform over cameras and pixels, or with masks uniform over the
        valid-pixel list, from ``generator`` (the trainer's by default)."""
        if self.images is None:
            raise ValueError("this trainer was built without images")
        n, h, w = self.images.shape[:3]
        gen = self._generator if generator is None else generator

        def randint(high):
            return torch.randint(0, high, (num_rays,), generator=gen, device=self.device)

        if self._valid_coords is not None:
            rows = self._valid_coords[randint(self._valid_coords.shape[0])]
            cam_idx, py, px = rows[:, 0], rows[:, 1], rows[:, 2]
        else:
            cam_idx, px, py = randint(n), randint(w), randint(h)
        return {
            "camera_indices": cam_idx,
            "pixel_x": px.to(torch.float32),
            "pixel_y": py.to(torch.float32),
            "image": self.images[cam_idx, py, px],
        }

    # ------------------------------------------------------------------ step
    def _loss_fn(
        self, batch: Mapping[str, torch.Tensor], step: int | torch.Tensor, draws: dict[str, Any] | None = None,
        dropout_masks: dict[str, torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Total loss and its terms at the current weights, with autograd.
        ``draws`` (``NerfactoModel.draw``'s layout) and ``dropout_masks``
        replace the generator's. Dropout applies when ``dropout_rate > 0``,
        as in the JAX trainer. ``step`` may be the device's counter."""
        rb = generate_rays(
            self.cameras,
            batch["camera_indices"],
            batch["pixel_x"],
            batch["pixel_y"],
            pose_adjustment=self.camera_opt,
        )
        if draws is None:
            draws = self.model.draw(rb.origins.shape[0], self._generator)
        cfg = self.config
        # as the JAX trainer: the corner layout shares its corners by construction
        face = cfg.face_consistency_mult > 0.0 and cfg.grid_layout in ("cell", "hybrid")
        if face:
            vertices = draws.get("face_vertices")
            if vertices is None:
                enc = self.model.field.encoding
                vertices = face_vertices([enc.resolutions[lvl] for lvl in enc.cell_levels()],
                                         cfg.face_consistency_samples, self._generator)
        dropout = (Dropout(masks=dropout_masks) if dropout_masks is not None
                   else ReplayDropout(self._generator))
        anneal = proposal_anneal_factor(step, self.config)

        def forward(rb):
            return self.model(rb, train=True, proposal_anneal=anneal, draws=draws,
                              deterministic_dropout=self.config.dropout_rate == 0.0, dropout=dropout)

        if self.gradient_checkpointing:
            # the trainer's generator is not one checkpoint preserves; the
            # draws and masks above make the recompute repeat the forward
            outputs = checkpoint(forward, rb, use_reentrant=False, preserve_rng_state=False)
        else:
            outputs = forward(rb)
        total, losses = nerfacto_loss(outputs, batch, self.config)
        if face:
            fc = cfg.face_consistency_mult * encoding_face_loss(self.model, vertices)
            losses["face_consistency_loss"] = fc
            total = total + fc
        return total, losses

    def _device_step(self, num_rays: int) -> torch.Tensor:
        """One step (a batch, the loss, its gradients, one update) with no
        host read: the loss terms and the total, (n_losses,) on the
        device, in ``_loss_names``' order."""
        batch = self.sample_batch(num_rays)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self._loss_fn(batch, self._step_t)
        total.backward()
        apply_updates(self.optimizer)
        self._step_t += 1
        self._loss_names = [*losses, "total_loss"]
        return torch.stack([*(v.detach() for v in losses.values()), total.detach()])

    def train_step(self, num_rays_per_batch: int = 4096) -> dict[str, float]:
        """One step, eagerly; its losses read back to the host."""
        values = self._device_step(num_rays_per_batch).tolist()
        self.step += 1
        return dict(zip(self._loss_names, values))

    def _capture(self, num_rays: int) -> _CapturedStep:
        """``_device_step`` captured into a CUDA graph, with the trainer's
        generator registered. The capture records without running; its
        launch counts are taken back and become the replays'."""
        with span("ungs.train.capture", captures=1):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self._generator)
            before = dict(backend.launch_counts)
            self.optimizer.zero_grad(set_to_none=True)
            with torch.cuda.graph(graph):
                losses = self._device_step(num_rays)
            launches = {k: backend.launch_counts[k] - n for k, n in before.items()}
            backend.launch_counts.update(before)
            return _CapturedStep(graph, losses, launches)

    def _launch(self, length: int, num_rays: int) -> np.ndarray:
        """``length`` steps with one host read: (length, n_losses)."""
        with span("ungs.train.launch", launches=1, steps=length):
            if self.device.type != "cuda":
                rows = torch.stack([self._device_step(num_rays) for _ in range(length)])
                self.step += length
                with span("ungs.train.read", host_reads=1):
                    return rows.cpu().numpy()
            rows, done = [], 0
            captured = self._graphs.get(num_rays)
            if captured is None:
                with span("ungs.train.warmup"):
                    side = torch.cuda.Stream(self.device)
                    side.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(side):
                        while done < min(WARMUP_STEPS, length):
                            rows.append(self._device_step(num_rays))
                            done += 1
                    torch.cuda.current_stream(self.device).wait_stream(side)
                if done < length:
                    captured = self._graphs[num_rays] = self._capture(num_rays)
            buffer = torch.empty((length, len(self._loss_names)), device=self.device)
            for i, row in enumerate(rows):
                buffer[i].copy_(row)
            for i in range(done, length):
                with span("ungs.train.replay", replays=1):
                    captured.graph.replay()
                    buffer[i].copy_(captured.losses)
            if done < length:
                backend.count_replays(captured.launches, length - done)
            self.step += length
            with span("ungs.train.read", host_reads=1):
                return buffer.cpu().numpy()

    def train(
        self,
        num_steps: int,
        num_rays_per_batch: int = 4096,
        log_every: int = 0,
        callback: Callable[[int, dict], None] | None = None,
        writer=None,
        steps_per_launch: int = 1,
    ) -> dict[str, float]:
        """``num_steps`` steps, ``steps_per_launch`` of them a launch (one
        host read each, under ``launch_lock``); ``writer.write(step,
        losses)`` every 10th and the last, ``callback(i, losses)`` after
        each, as in the JAX trainer."""
        if steps_per_launch < 1:
            raise ValueError(f"steps_per_launch must be at least 1, got {steps_per_launch}")
        losses: dict[str, float] = {}
        i = 0
        while i < num_steps:
            with self.launch_lock:
                if steps_per_launch == 1:
                    rows = [list(self.train_step(num_rays_per_batch).values())]
                else:
                    rows = self._launch(min(steps_per_launch, num_steps - i), num_rays_per_batch).tolist()
            base = self.step - len(rows)
            with span("ungs.train.rows"):
                for j, row in enumerate(rows):
                    losses = dict(zip(self._loss_names, row))
                    if writer is not None and ((i + j) % 10 == 0 or i + j == num_steps - 1):
                        writer.write(base + j + 1, losses)
                    if log_every and (i + j + 1) % log_every == 0:
                        print(f"step {i + j + 1}: " + ", ".join(f"{k}={v:.4f}" for k, v in losses.items()))
                    if callback is not None:
                        callback(i + j, losses)
            i += len(rows)
        return losses

    # ------------------------------------------------------------- rendering
    @torch.no_grad()
    def render_image(self, camera_idx: int, chunk: int | None = None) -> dict[str, np.ndarray]:
        """Full-image render in fixed-size ray chunks. The last chunk is
        padded with pixel (0, 0), as in the JAX package, and cut off after."""
        chunk = chunk or self.config.eval_num_rays_per_chunk
        h, w = self.cameras.height, self.cameras.width
        px, py = pixel_grid(h, w, self.device)
        total = h * w
        pad = (-total) % chunk
        zeros = torch.zeros(pad, dtype=torch.float32, device=self.device)
        px = torch.cat([px, zeros])
        py = torch.cat([py, zeros])
        idx = torch.full((total + pad,), camera_idx, dtype=torch.int64, device=self.device)
        outs: dict[str, list[torch.Tensor]] = {}
        for start in range(0, total + pad, chunk):
            rb = generate_rays(
                self.cameras,
                idx[start : start + chunk],
                px[start : start + chunk],
                py[start : start + chunk],
            )
            for k, v in self.model(rb).items():
                if k != "density_mean":
                    outs.setdefault(k, []).append(v)
        images = {}
        for k, parts in outs.items():
            flat = torch.cat(parts, dim=0)[:total].cpu().numpy()
            images[k] = flat.reshape((h, w) + flat.shape[1:])
        return images
