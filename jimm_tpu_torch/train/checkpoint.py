"""Training-run checkpoints: save and restore the model's parameters, the
optimizer state and the step; the counterpart of
``jimm_tpu/train/checkpoint.py``, whose semantics it keeps on its own
storage (orbax is JAX's).

Layout under the root, one directory per step::

    <root>/<step>/model.safetensors   the parameters (weights/safetensors_io)
    <root>/<step>/opt.safetensors     the optimizer state, keyed
                                      ``<parameter name>.<state key>``
    <root>/<step>/extra.json          the caller's ``extra``, when given
    <root>/<step>/checkpoint.json     metadata, parsed on every restore
    <root>/run.json                   the run's architecture, when its
                                      caller records one
    <root>/.jimm_markers/<step>       completion markers
    <root>/.quarantine/<step>[-n]/    steps that failed, with the reason

As the reference holds ``nnx.state(model, nnx.Param)`` and the optimizer
state, a checkpoint holds the parameters (no buffers: fp8 amax histories
restart on resume, as JAX's non-Param variables do), AdamW's per-parameter
state (``exp_avg`` in the moment dtype, ``exp_avg_sq``, and torch's
``step`` where AdamW keeps one) and the optimizer's update count.

``save`` copies every tensor to the host on the caller's thread (the next
step updates the parameters in place; the ``checkpoint_host_copy`` span),
then writes the files on one background thread (``checkpoint_write``).
The next ``save``, ``wait`` or ``close`` waits that write out and raises
its error, if any. A step is complete once its
marker exists: a marker is written only after its step's write is known
to have finished, and restore trusts markers, not directory listings.

On a mesh (``train --mesh``) every rank calls ``save`` and ``restore``:
a parameter or state tensor that FSDP2 shards, that ranks of a ``model``
axis hold slices of, or that another ``stage`` holds (a pipelined block)
is gathered whole (``parallel.sharding.gather_whole``, collectives) and
written by rank 0 alone (``writer``), so the files are those of an
unsharded run, blocks in their natural order under their own names (no
relayout: the port never stores a pipeline's circular order); a restore
puts each rank's piece of the saved tensors back. Each step's metadata
records the mesh layout it was saved under (``{"axes", "n_devices"}``),
and a restore onto another layout counts
``checkpoint_topology_changes_total`` (JAX's ``_note_mesh_change``).

A step that cannot be read (its metadata, files or JSON garbled) is
corrupt, and ``restore(step=None)`` quarantines it. A checkpoint that
reads well but does not fit the model or optimizer it is restored into
(keys, shapes, dtypes) is the caller's mismatch: it raises
:class:`CheckpointMismatchError` at once, and no step is touched.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from jimm_tpu_torch.obs import get_journal, get_registry, span
from jimm_tpu_torch.parallel.sharding import (gather_whole, local_piece,
                                              whole_names, whole_shape)
from jimm_tpu_torch.weights.safetensors_io import load_file, save_file

__all__ = ["CheckpointManager", "CheckpointMismatchError", "METADATA_FILE"]

MODEL_FILE = "model.safetensors"
OPT_FILE = "opt.safetensors"
EXTRA_FILE = "extra.json"
#: the per-step metadata, parsed on every restore (the fault drill's
#: ``corrupt@STEP`` garbles it)
METADATA_FILE = "checkpoint.json"
#: the run's recorded architecture, beside the step directories
RUN_FILE = "run.json"
FORMAT = "jimm_tpu_torch.checkpoint/1"
#: the longest ``wait``/``close`` waits for one step's background write
WRITE_TIMEOUT_S = 900.0


class CheckpointMismatchError(ValueError):
    """The checkpoint does not fit what it is restored into: other keys,
    shapes or dtypes, or another recorded run. The step is sound, so it is
    never quarantined."""


def _host_whole(model: nn.Module, tensors: dict[str, torch.Tensor],
                param_of=lambda key: key) -> dict[str, torch.Tensor]:
    """Copies in host memory (synchronous device-to-host copies for card
    tensors) of the whole tensors of this rank's ``tensors``
    (``sharding.gather_whole``: collectives, every rank of the mesh calls
    it)."""
    return {k: t.to("cpu", copy=True) for k, t in
            gather_whole(model, tensors, param_of).items()}


def _param_of(key: str) -> str:
    """The parameter an optimizer-state key ``<name>.<state>`` is of."""
    return key.rpartition(".")[0]


def _place(full: torch.Tensor, like: torch.Tensor, model: nn.Module,
           name: str) -> torch.Tensor:
    """The saved whole tensor ``full`` of parameter ``name`` laid out like
    ``like``: this rank's slice of it on a ``model`` axis, on ``like``'s
    device, and for an FSDP2 ``DTensor`` this rank's shard of that (cut
    locally; every rank read the same file)."""
    full = local_piece(model, name, full).to(like.device, copy=True)
    if isinstance(like, DTensor):
        return distribute_tensor(full, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return full


def mesh_layout(mesh) -> dict[str, Any] | None:
    """The mesh a state is saved under, ``{"axes": {name: size},
    "n_devices": n}`` (None: no mesh)."""
    if mesh is None:
        return None
    axes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {"axes": {str(k): int(v) for k, v in axes.items()},
            "n_devices": int(mesh.mesh.numel())}


def _names(model: nn.Module) -> dict[int, str]:
    return {id(p): name for name, p in model.named_parameters()}


def _state_spec(optimizer, p: torch.Tensor
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype,
                                     torch.device]]:
    """The state keys an AdamW update leaves on ``p``, each with its
    shape, dtype and device: torch's ``step`` (a 0-d f32 tensor, on the
    host unless the group is capturable or fused), ``exp_avg`` and
    ``exp_avg_sq``; without ``step`` under a ``moment_dtype`` (the port's
    own update, with ``exp_avg`` in that dtype)."""
    moment = optimizer.moment_dtype
    spec = {"exp_avg": (tuple(p.shape), moment or p.dtype, p.device),
            "exp_avg_sq": (tuple(p.shape), p.dtype, p.device)}
    if moment is None:
        group = next(g for g in optimizer.opt.param_groups
                     if any(q is p for q in g["params"]))
        on_device = group.get("capturable") or group.get("fused")
        spec = {"step": ((), torch.float32,
                         p.device if on_device else torch.device("cpu")),
                **spec}
    return spec


def _optimizer_tensors(model: nn.Module, optimizer
                       ) -> dict[str, torch.Tensor]:
    names = _names(model)
    out: dict[str, torch.Tensor] = {}
    for p in optimizer.params:
        if id(p) not in names:
            raise KeyError("the optimizer holds a parameter the model does "
                           "not have")
        for key, value in optimizer.opt.state.get(p, {}).items():
            if not torch.is_tensor(value):
                raise TypeError(f"optimizer state {names[id(p)]}.{key} is "
                                f"not a tensor ({type(value).__name__})")
            out[f"{names[id(p)]}.{key}"] = value
    return _host_whole(model, out, _param_of)


def _check(name: str, got: torch.Tensor, shape: tuple[int, ...],
           dtype: torch.dtype, cast: bool = False) -> torch.Tensor:
    """``got`` as a tensor of ``shape``: a 0-d tensor comes back with shape
    (1,) (the safetensors writer's rule, as the reference's). A shape
    mismatch raises, and so does a dtype mismatch unless ``cast``."""
    if shape == () and tuple(got.shape) == (1,):
        got = got.reshape(())
    if cast and tuple(got.shape) == shape:
        got = got.to(dtype)
    if tuple(got.shape) != shape or got.dtype != dtype:
        raise CheckpointMismatchError(
            f"{name}: saved {got.dtype} {tuple(got.shape)}, expected "
            f"{dtype} {shape}")
    return got


class CheckpointManager:
    """Save and restore training state under ``directory``, one step per
    subdirectory.

    ``save_interval_steps`` and ``max_to_keep`` follow orbax's rules (the
    reference's storage): a save is taken when its step is newer than the
    newest saved and is on the interval grid or no step is saved yet, or
    when forced; the newest ``max_to_keep`` steps are kept (None: all), an
    older one is deleted after the write of the save that displaced it.

    ``run``: the architecture of the run the directory holds (a flat dict of
    JSON values). The first manager given one records it in ``run.json``;
    a later one given another raises :class:`CheckpointMismatchError`
    before any step is read. ``self.run`` is the record, or None.

    ``mesh``: the mesh the live model is laid out over (None: unsharded),
    recorded with each save. ``writer``: whether this rank writes (rank 0
    of a mesh; every other rank only takes part in the gathers).
    """

    def __init__(self, directory: str | os.PathLike, *,
                 max_to_keep: int | None = 3, save_interval_steps: int = 1,
                 run: dict[str, Any] | None = None, mesh=None,
                 writer: bool = True):
        self._dir = Path(directory).absolute()
        self.mesh = mesh
        self.writer = writer
        #: the last restore's ``{"step", "saved", "current"}`` layouts when
        #: it crossed a mesh change, else None
        self.last_topology_change: dict[str, Any] | None = None
        if writer:
            self._dir.mkdir(parents=True, exist_ok=True)
        path = self._dir / RUN_FILE
        self.run: dict[str, Any] | None = (json.loads(path.read_text())
                                           if path.exists() else None)
        if run is not None and self.run is None and not writer:
            self.run = dict(run)
        elif run is not None and self.run is None:
            tmp = self._dir / f".{RUN_FILE}.tmp"
            tmp.write_text(json.dumps(run))
            os.replace(tmp, path)
            self.run = dict(run)
        elif run is not None and run != self.run:
            differ = ", ".join(
                f"{k} {self.run.get(k)!r} (given {run.get(k)!r})"
                for k in sorted(set(run) | set(self.run))
                if run.get(k) != self.run.get(k))
            raise CheckpointMismatchError(
                f"{self._dir} holds a run of another configuration: {differ}")
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        # hidden names: never a step directory
        self._markers = self._dir / ".jimm_markers"
        #: steps whose write was started but is not yet known finished
        self._pending: list[int] = []
        #: the caller's ``extra`` of the last restored step
        self.last_restored_extra: dict[str, Any] = {}
        #: the saved steps, oldest first (orbax's step list: steps with a
        #: metadata file at creation and after a quarantine, plus saves)
        self._steps: list[int] = []
        self._reload()
        self._executor: ThreadPoolExecutor | None = None
        self._write: tuple[int, Any] | None = None  # (step, future)

    @property
    def directory(self) -> Path:
        return self._dir

    # -- save -------------------------------------------------------------

    def _should_save(self, step: int) -> bool:
        if self._steps and max(self._steps) >= step:
            return False
        return step % self.save_interval_steps == 0 or not self._steps

    def save(self, step: int, model: nn.Module, optimizer=None, *,
             extra: dict[str, Any] | None = None, force: bool = False
             ) -> bool:
        """Save ``model``'s parameters (and ``optimizer``'s state) at
        ``step``: the host copy now, the files in the background. Returns
        False when the step is off the save grid (see the class) and not
        ``force``d."""
        with span("checkpoint_save"):
            saved = force or self._should_save(step)
            if saved:
                # one write at a time: wait out (and surface) the last one
                self._wait_write()
                if step in self._steps:
                    raise ValueError(f"Checkpoint for step {step} already "
                                     f"exists.")
                with span("checkpoint_host_copy"):
                    params = _host_whole(model, dict(
                        model.named_parameters()))
                    opt = (_optimizer_tensors(model, optimizer)
                           if optimizer is not None else None)
                meta = {"format": FORMAT, "step": step,
                        "mesh": mesh_layout(self.mesh),
                        "params": len(params),
                        "optimizer": None if optimizer is None else {
                            "count": int(optimizer.count),
                            "tensors": len(opt)},
                        "extra": extra is not None}
                self._steps.append(step)
                keep = self.max_to_keep
                remove = ([] if keep is None or len(self._steps) <= keep
                          else self._steps[:len(self._steps) - keep])
                del self._steps[:len(remove)]
                if not self.writer:
                    # the gathers above were this rank's part of the save
                    return True
                if self._executor is None:
                    self._executor = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="jimm-ckpt-write")
                self._write = (step, self._executor.submit(
                    self._write_step, step, params, opt, extra, meta,
                    remove))
        if saved:
            # the previous write is finished (waited above): its marker
            # can land; this step's waits for the next save/wait/close
            self._flush_markers()
            self._pending.append(step)
            get_registry("jimm_train").counter("checkpoint_saves_total").inc()
        return saved

    def _write_step(self, step: int, params: dict[str, torch.Tensor],
                    opt: dict[str, torch.Tensor] | None,
                    extra: dict[str, Any] | None, meta: dict,
                    remove: list[int]) -> None:
        """The background part of a save: the files, metadata last, then
        the steps it displaced."""
        with span("checkpoint_write"):
            d = self._dir / str(step)
            d.mkdir(parents=True, exist_ok=True)
            save_file(params, d / MODEL_FILE)
            if opt is not None:
                save_file(opt, d / OPT_FILE)
            if extra is not None:
                (d / EXTRA_FILE).write_text(json.dumps(extra))
            (d / METADATA_FILE).write_text(json.dumps(meta))
            for old in remove:
                shutil.rmtree(self._dir / str(old), ignore_errors=True)

    def _wait_write(self) -> None:
        """Wait for the background write, if one runs; its error (or a
        timeout) is raised here, and its step is never marked complete."""
        if self._write is None:
            return
        step, future = self._write
        self._write = None
        try:
            future.result(timeout=WRITE_TIMEOUT_S)
        except Exception:
            if step in self._pending:
                self._pending.remove(step)
            raise

    # -- completion markers -------------------------------------------------
    # A step directory exists from the moment its write starts, so a kill
    # mid-write leaves one that looks like any other. A marker (written
    # through a tmp file and an atomic rename) lands only once the step's
    # write is known finished; restore trusts markers.

    def _write_marker(self, step: int) -> None:
        self._markers.mkdir(exist_ok=True)
        tmp = self._markers / f".{step}.tmp"
        tmp.write_text("complete\n")
        os.replace(tmp, self._markers / str(step))

    def _flush_markers(self) -> None:
        if not self._pending:
            return
        for step in self._pending:
            self._write_marker(step)
        self._pending.clear()
        from jimm_tpu_torch.resilience.supervisor import (
            note_checkpoint_completed)
        note_checkpoint_completed()

    def _marked_steps(self) -> set[int] | None:
        """Steps with a completion marker, or None when the tree has no
        markers at all (then the directory listing is all there is)."""
        if not self._markers.is_dir():
            return None
        marked = {int(p.name) for p in self._markers.iterdir()
                  if p.name.isdigit()}
        return marked or None

    def _steps_on_disk(self) -> set[int]:
        if not self._dir.is_dir():
            return set()
        return {int(p.name) for p in self._dir.iterdir()
                if p.is_dir() and p.name.isdigit()}

    def _reload(self) -> None:
        self._steps = sorted(s for s in self._steps_on_disk()
                             if (self._dir / str(s) / METADATA_FILE).exists())

    def completed_steps(self) -> list[int]:
        """Ascending steps that are both on disk and marked complete."""
        existing = self._steps_on_disk()
        marked = self._marked_steps()
        if marked is None:
            return sorted(existing)
        return sorted(existing & marked)

    def latest_step(self) -> int | None:
        """Newest completed (marker-verified) step."""
        steps = self.completed_steps()
        return steps[-1] if steps else None

    def quarantine_step(self, step: int, reason: str) -> Path | None:
        """Move a bad step directory into ``.quarantine/`` (never delete:
        the bytes stay for a post-mortem). Returns the new location, or
        None when the move lost a race."""
        src = self._dir / str(step)
        qdir = self._dir / ".quarantine"
        try:
            qdir.mkdir(exist_ok=True)
            dest = qdir / str(step)
            n = 0
            while dest.exists():
                n += 1
                dest = qdir / f"{step}-{n}"
            os.replace(src, dest)
            (dest / ".jimm_quarantine_reason.txt").write_text(reason + "\n")
        except OSError:
            return None
        (self._markers / str(step)).unlink(missing_ok=True)
        get_registry("jimm_train").counter(
            "checkpoint_quarantined_total").inc()
        get_journal().emit("checkpoint_quarantined", step=step,
                           reason=reason, dest=str(dest))
        self._reload()
        return dest

    def _sweep_partial_dirs(self, *, newer_than: int) -> None:
        """Quarantine unmarked step directories newer than the newest
        completed step: what a kill mid-write leaves behind."""
        marked = self._marked_steps()
        if marked is None:
            return
        for step in self._steps_on_disk():
            if (step > newer_than and step not in marked
                    and step not in self._pending):
                self.quarantine_step(
                    step, "partial write (no completion marker)")

    # -- restore ------------------------------------------------------------

    def restore(self, model: nn.Module, optimizer=None, *,
                step: int | None = None, cast: bool = False) -> int:
        """Restore in place (each tensor on its current device); returns
        the restored step.

        With ``step=None`` the newest completed checkpoint is used: partial
        step directories are swept aside first, and a step that cannot be
        read is quarantined (never deleted), with a ``RuntimeWarning``,
        before the previous step is tried. An explicit ``step`` restores
        exactly that step and raises its errors. A checkpoint that does not
        fit ``model`` or ``optimizer`` raises
        :class:`CheckpointMismatchError` either way, quarantining nothing.
        ``cast``: convert each saved parameter to its target's dtype, as
        orbax does (the optimizer state stays strict)."""
        if step is not None:
            return self._restore_step(step, model, optimizer, cast)
        candidates = self.completed_steps()
        if not candidates:
            raise FileNotFoundError("no checkpoint found")
        if self.writer:
            self._sweep_partial_dirs(newer_than=candidates[-1])
        for cand in reversed(candidates):
            try:
                return self._restore_step(cand, model, optimizer, cast)
            except CheckpointMismatchError:
                raise  # the caller's model does not fit: no step is bad
            except Exception as e:
                dest = None if not self.writer else self.quarantine_step(
                    cand, f"restore failed: {type(e).__name__}: {e}")
                warnings.warn(
                    f"checkpoint step {cand} failed to restore "
                    f"({type(e).__name__}: {e}); quarantined to {dest}, "
                    f"falling back to the previous good step",
                    RuntimeWarning, stacklevel=2)
        raise FileNotFoundError(
            f"no restorable checkpoint: all {len(candidates)} candidate "
            f"step(s) failed and were quarantined")

    def _restore_step(self, step: int, model: nn.Module, optimizer=None,
                      cast: bool = False) -> int:
        get_registry("jimm_train").counter("checkpoint_restores_total").inc()
        # joins the ambient incident chain when the supervisor restarts
        get_journal().emit("checkpoint_restored", step=step)
        with span("checkpoint_restore"):
            d = self._dir / str(step)
            meta = json.loads((d / METADATA_FILE).read_text())
            if not isinstance(meta, dict) or meta.get("format") != FORMAT \
                    or meta.get("step") != step:
                raise ValueError(f"{d / METADATA_FILE} is not the metadata "
                                 f"of step {step}")
            extra = (json.loads((d / EXTRA_FILE).read_text())
                     if meta.get("extra") else {})
            # every check before any write: a failed restore leaves the
            # model and optimizer as they were
            # on a stage axis this rank holds some of the blocks
            targets = dict(model.named_parameters())
            whole = set(whole_names(model))
            saved = load_file(d / MODEL_FILE)
            if set(saved) != whole:
                raise CheckpointMismatchError(
                    f"checkpoint parameters differ from the model's: "
                    f"missing {sorted(whole - set(saved))[:5]}, "
                    f"unexpected {sorted(set(saved) - whole)[:5]}")
            params = {name: _check(name, saved[name],
                                   whole_shape(model, name, p.shape), p.dtype,
                                   cast)
                      for name, p in targets.items()}
            if optimizer is not None:
                opt_meta = meta.get("optimizer")
                if not opt_meta:
                    raise CheckpointMismatchError(
                        f"step {step} holds no optimizer state")
                state = self._optimizer_state(d, model, optimizer)
            with torch.no_grad():
                for name, t in params.items():
                    targets[name].copy_(_place(t, targets[name], model,
                                               name))
            if optimizer is not None:
                for p, entries in state.items():
                    optimizer.opt.state[p] = entries
                optimizer.count = int(opt_meta["count"])
            self.last_restored_extra = dict(extra)
            self._note_mesh_change(step, meta.get("mesh"))
        return step

    def _note_mesh_change(self, step: int, saved: dict | None) -> None:
        """A restore onto another mesh layout than the save's: counted in
        ``checkpoint_topology_changes_total`` and journalled (the tensors
        need no other care: they are saved whole and cut on restore)."""
        current = mesh_layout(self.mesh)
        if saved is None or current is None or saved == current:
            return
        self.last_topology_change = {"step": step, "saved": saved,
                                     "current": current}
        get_registry("jimm_train").counter(
            "checkpoint_topology_changes_total").inc()
        get_journal().emit("mesh_resharded", step=step, saved=saved,
                           current=current)

    def _optimizer_state(self, d: Path, model: nn.Module, optimizer
                         ) -> dict[torch.Tensor, dict[str, torch.Tensor]]:
        """The saved optimizer state, checked and placed: for each of the
        optimizer's parameters its state entries (none where the saved
        step had none). Every saved tensor must be used."""
        saved = load_file(d / OPT_FILE)
        names = _names(model)
        # the state of the blocks other stages hold is theirs to use
        others = set(whole_names(model)) - set(names.values())
        unused = {k for k in saved if _param_of(k) not in others}
        state: dict[torch.Tensor, dict[str, torch.Tensor]] = {}
        for p in optimizer.params:
            name = names[id(p)]
            spec = {k: (whole_shape(model, name, shape), dtype, device)
                    for k, (shape, dtype, device) in _state_spec(
                        optimizer, p).items()}
            keys = [k for k in spec if f"{name}.{k}" in saved]
            if keys and len(keys) != len(spec):
                raise CheckpointMismatchError(
                    f"{name}: saved optimizer state {keys}, expected all "
                    f"of {list(spec)}")
            entries = {}
            for key in keys:
                shape, dtype, device = spec[key]
                full = f"{name}.{key}"
                t = _check(full, saved[full], shape, dtype)
                entries[key] = (t.to(device, copy=True) if key == "step"
                                else _place(t, p, model, name))
                unused.discard(full)
            state[p] = entries
        if unused:
            raise CheckpointMismatchError(
                f"saved optimizer state not used: {sorted(unused)[:5]}")
        return state

    # -- lifetime -------------------------------------------------------------

    def wait(self) -> None:
        """Wait for the background write and mark its step complete."""
        self._wait_write()
        self._flush_markers()

    def close(self) -> None:
        """:meth:`wait`, then stop the writer thread."""
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
