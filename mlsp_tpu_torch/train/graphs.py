"""Fused step dispatch on the card: CUDA graphs of the train step and of the
eval forward (the counterpart of the JAX package's scanned programs,
`pointda_train_scan`, `pointsegda_train_scan`, `spst_train_scan` and
`eval_scan`, which run S steps or forwards as one XLA program).

`capture(fn)` is the one capture of the module: `fn()` once on a side
stream (the warm-up torch's whole-network capture asks for; it creates
lazy state, such as the optimizer's), then `fn()` again inside a new
CUDA graph, with a generator registered if one is given; the kernels'
launch counts of both calls are put back and the launches of one replay
returned, so that whoever replays the graph can count them
(`ops.kernels.add_launches`).

A `ChunkGraph` is `fn` captured over static inputs stacked [S, ...] and a
step counter on the card: each replay takes the counter's slice of the
inputs, runs `fn` on it (with static 0-d inputs that every step reads
alike) and writes its outputs into stacked [S, ...] buffers, then
advances the counter. A chunk of r <= S is then its inputs copied in and
r replays with no Python work between them: a full chunk of `scan_steps`,
an epoch's tail of fewer, or the single step of `scan_steps` 1 (the
counterpart of JAX's jitted single step) all replay one graph.

A `StepGraph` is the ChunkGraph of one train step (zero_grad with
set_to_none, forward, backward, the optimizer update) over a chunk's
clouds and labels, with SPST's loss weights as static 0-d inputs. Each
replay reads the optimizer's LR tensors as they are: every schedule of
the port is constant within an epoch and a chunk never crosses an epoch,
so the scheduler is stepped r times after the r replays
(`steps.run_chunk`) and its count and the next LR are those of r eager
steps. Its warm-up
step is undone before the capture: the model's parameters and buffers
(BN statistics), the optimizer's state and LRs and the generator are put
back as they were, state that the warm-up created zeroed (a fresh Adam
moment, step count or momentum buffer equals zero). SGD's momentum
buffers thus exist before capture, else the graph would hold its
first-step branch. The step's `torch.Generator` is registered with the
graph: each replay draws from the generator's Philox stream where an
eager step would, and leaves its offset where the eager step leaves it.
Every draw of every recipe is such a device op, PCM's Beta(a, a) ratio
at any `mixup_params` included (`steps.draw_mix_ratio`: gammas and
uniforms of the generator), so a step graph holds every recipe.

An `EvalGraph` is the ChunkGraph of one eval forward (eval mode, no
dropout, no statistics update) over [chunk, B, ...] batches; a rank of an
NCCL mesh captures its own rows (under a points axis with the points
group's gathers inside). `Graphs` keeps a run's graphs in one memory
pool; a graph is captured again when the state it reads moved (the
optimizer's state tensors after `load_state_dict`, another model,
optimizer or generator) or a chunk outgrows it. The graphs
refuse CPU tensors: on the CPU the scan functions take their steps
eagerly. The kernels' launchers need no change to be captured: their
per-launch `cudaFuncSetAttribute` is host-side and legal while a stream
captures in torch's global mode (`tests/test_torch_port_cuda.py`: the
step graphs replay every kernel, K1's query range and K2-bwd replay
graphs of their own).
Under an NCCL (data, points) mesh the step graph holds the points
group's collectives (the gathered kNN rows, Chamfer's cotangent sums)
beside the data group's: the warm-up step runs every one of them, so
each group's communicator exists before the capture.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from mlsp_tpu_torch.ops import kernels
from mlsp_tpu_torch.train.state import lr_tensors
from mlsp_tpu_torch.utils.profiling import span


def stack_steps(outs: list):
    """Per-step outputs (pytrees of tensors alike) stacked over the steps:
    what a graph's chunk returns."""
    leaves = [pytree.tree_flatten(o)[0] for o in outs]
    spec = pytree.tree_flatten(outs[0])[1]
    return pytree.tree_unflatten([torch.stack(ts) for ts in zip(*leaves)],
                                 spec)


def unstack_steps(stacked) -> list:
    """The inverse of `stack_steps`: one output pytree per step."""
    leaves, spec = pytree.tree_flatten(stacked)
    return [pytree.tree_unflatten([t[i] for t in leaves], spec)
            for i in range(leaves[0].shape[0])]


def _check_cuda(tensors, what: str) -> torch.device:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what}: needs CUDA tensors, got {t.device} "
                             "(the CPU takes the steps eagerly)")
    return tensors[0].device


def _fingerprint(model, opt=None, generator=None) -> tuple:
    """What a graph holds by address: the model's tensors, the optimizer's
    state and LR tensors, the generator."""
    ptrs = [t.data_ptr() for t in (*model.parameters(), *model.buffers())]
    if opt is not None:
        for st in opt.state.values():
            ptrs += [v.data_ptr() for v in st.values()
                     if isinstance(v, torch.Tensor)]
        ptrs += [id(t) for t in lr_tensors(opt)]
    return (id(model), id(opt), id(generator), tuple(ptrs))


def _snapshot(model, opt, generator):
    tensors = [*model.parameters(), *model.buffers(), *lr_tensors(opt)]
    for st in opt.state.values():
        tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return [(t, t.detach().clone()) for t in tensors], generator.get_state()


@torch.no_grad()
def _restore(snapshot, opt, generator) -> None:
    saved, gen_state = snapshot
    for t, v in saved:
        t.copy_(v)
    kept = {id(t) for t, _ in saved}
    for st in opt.state.values():
        for v in st.values():
            if isinstance(v, torch.Tensor) and id(v) not in kept:
                v.zero_()
    generator.set_state(gen_state)


def capture(fn, device, pool=None, generator=None, warmed_up=None):
    """`fn()` captured into a new CUDA graph (see the module docstring):
    one warm-up call on a side stream, `warmed_up(its output)` if given,
    then the capture, with `generator` registered. Launch counts are
    left as they were. Returns the graph, the captured call's output (in
    the graph's memory: each replay overwrites it) and the kernel
    launches of one replay."""
    counts = kernels.launches()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    if warmed_up is not None:
        warmed_up(out)
    del out
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = kernels.launches()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    after = kernels.launches()
    kernels.set_launches(counts)
    return graph, out, {k: after[k] - before[k] for k in after}


class ChunkGraph:
    """`fn(*step_inputs, *consts)` captured over stacked inputs (see the
    module docstring).

    Args:
      fn: takes one step's slice of each input, then the consts; returns
        a pytree of tensors.
      inputs: stacked [r, ...] CUDA tensors, r >= 1; the graph keeps
        copies in [steps, ...] buffers (the warm-up and the capture read
        the first step).
      consts: 0-d CUDA tensors `fn` reads at every step.
      pool, generator: as `capture`.
      restore: called after the warm-up call, to undo what it did.
      steps: the longest chunk it replays (default r).
    """

    def __init__(self, fn, inputs, consts=(), pool=None, generator=None,
                 restore=None, steps: int | None = None):
        dev = _check_cuda([*inputs, *consts], type(self).__name__)
        steps = max(steps or 0, inputs[0].shape[0])
        self.inputs = [t.new_empty((steps, *t.shape[1:])) for t in inputs]
        for buf, t in zip(self.inputs, inputs):
            buf[:t.shape[0]].copy_(t)
        self.consts = [t.clone() for t in consts]
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.outs = None

        def one_step():
            i = self.slot.view(1)
            out = fn(*(t.index_select(0, i)[0] for t in self.inputs),
                     *self.consts)
            if self.outs is not None:  # the captured call, not the warm-up
                for buf, o in zip(self.outs, pytree.tree_leaves(out)):
                    buf.index_copy_(0, i, o.unsqueeze(0))
                self.slot.add_(1)
            return out

        def warmed_up(out):
            if restore is not None:
                restore()
            flat, self.spec = pytree.tree_flatten(out)
            self.outs = [o.new_empty((steps, *o.shape)) for o in flat]

        self.graph, _, self.launches = capture(one_step, dev, pool,
                                               generator, warmed_up)

    def run(self, inputs, consts=()):
        """r <= S replays on the stacked `inputs` [r, ...] with `consts`;
        returns the outputs stacked over r, a pytree like `fn`'s. Spans:
        "copy_in", "replay", "outputs"."""
        r = inputs[0].shape[0]
        if r > self.inputs[0].shape[0] or [t.shape[1:] for t in inputs] != [
                t.shape[1:] for t in self.inputs]:
            raise ValueError(
                f"{type(self).__name__}.run: {[tuple(t.shape) for t in inputs]}"
                f" does not fit {[tuple(t.shape) for t in self.inputs]}")
        with span("copy_in"):
            for buf, t in zip(self.inputs, inputs):
                buf[:r].copy_(t)
            for buf, t in zip(self.consts, consts):
                buf.copy_(t)
            self.slot.zero_()
        with span("replay"):
            for _ in range(r):
                self.graph.replay()
        kernels.add_launches(self.launches, r)
        with span("outputs"):
            return pytree.tree_unflatten([o[:r].clone() for o in self.outs],
                                         self.spec)


class StepGraph(ChunkGraph):
    """One captured train step (see the module docstring).

    Args:
      step: `step(*batch, *consts)` takes one step on one batch (the
        chunk's inputs sliced at a step) and returns its outputs, a
        pytree of tensors; it calls `opt.step()` and never the scheduler.
      inputs: the stacked [r, ...] CUDA tensors of a chunk.
      consts: 0-d CUDA tensors the step reads, the same for every step of
        a chunk.
      model, opt, generator: what the step updates and draws from.
      pool: a graph memory pool to share.
      steps: the longest chunk it replays (default r).
    """

    def __init__(self, step, inputs, consts, model, opt, generator,
                 pool=None, steps: int | None = None):
        _check_cuda([*inputs, *consts], "StepGraph")
        snap = _snapshot(model, opt, generator)
        super().__init__(step, inputs, consts, pool, generator,
                         lambda: _restore(snap, opt, generator), steps)
        # the graph writes the gradients here at every replay: keep them
        # out of the shared pool whatever later eager steps do to .grad
        self._grads = [p.grad for p in model.parameters()]


class EvalGraph(ChunkGraph):
    """One captured eval forward `forward(x)` over a static [chunk, ...]
    input; `run(xs)` replays it once per batch of xs [r <= chunk, ...].
    Capture it in eval mode and under `torch.inference_mode()`, and run it
    so."""

    def __init__(self, forward, example: torch.Tensor, chunk: int,
                 pool=None):
        super().__init__(forward, [example[None]], pool=pool, steps=chunk)

    def run(self, xs: torch.Tensor) -> torch.Tensor:
        return super().run([xs])


class Graphs:
    """The step and eval graphs of one run, in one memory pool: a train
    step graph per key (the caller's: the step's kind, recipe and one
    step's input shapes), which serves every chunk up to its length; an
    eval graph per (model, output, batch shape, chunk, mesh)."""

    def __init__(self):
        self._graphs: dict = {}
        self._pool = None

    def _get(self, key, fingerprint, build, steps: int = 1):
        """The graph of `key`, captured now by `build(pool)` if there is
        none, the state it holds moved (`fingerprint()`, taken after the
        capture: its warm-up may create optimizer state) or it holds fewer
        than `steps` steps. A capture is the span "capture"."""
        g = self._graphs.get(key)
        if (g is not None and g.fingerprint == fingerprint()
                and g.inputs[0].shape[0] >= steps):
            return g
        self._graphs.pop(key, None)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with span("capture"):
            g = build(self._pool)
            g.fingerprint = fingerprint()
        self._graphs[key] = g
        return g

    def train_step(self, key, step, inputs, consts, model, opt,
                   generator, steps: int = 1) -> StepGraph:
        """The StepGraph of `key` for chunks of up to max(steps, r)."""
        steps = max(steps, inputs[0].shape[0])
        return self._get(
            ("train", key), lambda: _fingerprint(model, opt, generator),
            lambda pool: StepGraph(step, inputs, consts, model, opt,
                                   generator, pool, steps), steps)

    def eval_forward(self, model, output: str, forward, example, chunk: int,
                     mesh=None) -> EvalGraph:
        """The EvalGraph of `forward` on batches like `example` (a mesh
        rank's rows), its own for each mesh: under a points axis it holds
        the points group's gathers."""
        return self._get(
            ("eval", id(model), output, tuple(example.shape), chunk, mesh),
            lambda: _fingerprint(model),
            lambda pool: EvalGraph(forward, example, chunk, pool))
