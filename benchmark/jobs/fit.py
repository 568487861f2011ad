"""Training: one ``GRU4Rec.fit`` call of ``1 + E`` epochs over a click stream
made from the seed; epoch 1 is set-up, epochs 2 .. E + 1 are the window.

Set-up gives the program the benchmark's weights (``fit(retrain=True)``
on a model that holds them and no optimizer state: a fresh optimizer and
generator, seeded from the run's seed) and watches the window's own call
(:class:`Probe`): the first ``checked_steps`` steps of epoch 1 run one
per call of the program's chunk function, on negatives that the
benchmark drew (its ``neg``), so that the program's generator draws the
dropout masks alone there; the optimizer state after step 1 and the
parameters after the last checked step are read from the training state
it is handed. The reference follows the same steps from the same weights,
clicks, negatives and dropout generator seed. The negatives that the
program's own sampler draws for the window's first chunk are held
against ``pop ** alpha`` (``compare.sampler_gap``).

The window runs from the first chunk call of epoch 2 to the return of
``fit``, on the benchmark's clock. ``E`` is ``seconds / nominal_epoch_s``
rounded, at least 1: a faster program gets a shorter window, of the same
work.

With tracing, the window's second chunk is split and its first
``traced_steps`` steps run under the profiler.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.jobs import common
from benchmark.reference import gru4rec as ref
from benchmark.yardstick import compare, generators, stats, tracing, weights

LEAVES = ("Wx", "Wh", "Wrz", "Bh", "Wy")


def clicks(cell, run):
    """The training stream: ``synth_split``'s train part at about
    ``clicks_per_epoch`` clicks, every item of the catalog in it."""
    c, t = cell.config, cell.traffic
    train, _ = generators.synth_split(
        run.stream("clicks"), int(c["n_items"]), c["clicks"]["mean_session_len"],
        int(math.ceil(t["clicks_per_epoch"] / 0.9)), c["clicks"]["zipf"])
    return train


def draw_negatives(rng, pop, alpha, steps, n_sample):
    p = pop.astype(np.float64) ** alpha
    return rng.choice(len(pop), size=(steps, n_sample), p=p / p.sum()).astype(np.int32)


class Probe:
    """The window's own ``fit`` call, watched through two names of the
    program, each wrapped for the call: ``models.gru4rec.make_chunk_fn``
    (its chunk function, with its ``neg=``) and ``train.step.draw_negatives``
    (the chunk function's negative draw). Every chunk call is stamped on
    the benchmark's clock with the epochs ``fit`` has completed by then
    (``model.epoch_stats``). The first call runs its first ``len(negs)``
    steps one per call on the benchmark's negatives and reads adagrad's
    accumulators (``state.opt_state``) after step 1 and the parameters after
    the last; the draw of the window's first chunk is kept; with tracing,
    the window's second chunk is split and its first ``trace_steps`` steps
    run under the profiler."""

    def __init__(self, model, negs, trace_steps, device):
        self.model = model
        self.negs = negs
        self.trace_steps = trace_steps
        self.device = device
        self.calls = []       # (benchmark clock, epochs completed) at each chunk call
        self.costs, self.grad_norms, self.after = [], None, None
        self.drawn = None     # the program's negatives of the window's first chunk
        self.region = None
        self.traced = {}

    def epoch_starts(self):
        """The benchmark clock at each epoch's first chunk call."""
        starts = {}
        for t, done in self.calls:
            starts.setdefault(done, t)
        return [starts[e] for e in sorted(starts)]

    def wrap_draw(self, draw_negatives):
        def tapped(*args, **kw):
            neg = draw_negatives(*args, **kw)
            if self.calls[-1][1] == 1 and sum(d == 1 for _, d in self.calls) == 1:
                self.drawn = neg.clone()
            return neg

        return tapped

    def wrap(self, make_chunk_fn):
        def wrapped(cfg, n_items, *args, **kw):
            fn = make_chunk_fn(cfg, n_items, *args, **kw)

            def chunk_fn(state, in_c, out_c, valid_c, reset_c, samp1, logp0, neg=None,
                         sr_seeds=None):
                self.calls.append((common.now(), len(self.model.epoch_stats)))
                sched = (in_c, out_c, valid_c, reset_c)
                if len(self.calls) == 1:
                    return self._checked(fn, state, sched, samp1, logp0)
                if self.trace_steps and sum(d == 1 for _, d in self.calls) == 2:
                    return self._traced(fn, state, sched, samp1, logp0)
                return fn(state, *sched, samp1, logp0, neg, sr_seeds)

            chunk_fn.runner = getattr(fn, "runner", None)
            return chunk_fn

        return wrapped

    def _part(self, fn, state, sched, lo, hi, samp1, logp0, neg=None):
        return fn(state, *(a[lo:hi] for a in sched), samp1, logp0, neg)

    def _checked(self, fn, state, sched, samp1, logp0):
        import torch

        n = len(self.negs)
        losses, events = [], 0
        for t in range(n):
            neg = torch.from_numpy(self.negs[t:t + 1]).to(self.device)
            ls, ec = self._part(fn, state, sched, t, t + 1, samp1, logp0, neg)
            losses.append(ls)
            events += ec
            self.costs.append(float(ls) / int(sched[2][t].sum()))
            if t == 0:
                dense, sparse = state.opt_state["dense"], state.opt_state["sparse"]
                acc = {k: dense[k][0]["acc"] for k in LEAVES[:-1]}
                acc["Wy"] = sparse["Wy"]["acc"]
                self.grad_norms = {k: float(torch.sqrt(a.double().sum())) for k, a in acc.items()}
        self.after = {k: v.detach().cpu().clone()
                      for k, v in weights.flat(state.params).items()}
        ls, ec = self._part(fn, state, sched, n, len(sched[0]), samp1, logp0)
        return torch.stack(losses + [ls]).sum(), events + ec

    def _traced(self, fn, state, sched, samp1, logp0):
        import torch

        k = min(self.trace_steps, len(sched[0]))
        out = []
        self.region = tracing.profile(
            lambda: out.append(self._part(fn, state, sched, 0, k, samp1, logp0)))
        self.traced = {"events": int(sched[2][:k].sum()),
                       "steps": int((sched[2][:k].sum(axis=1) > 0).sum())}
        if k < len(sched[0]):
            out.append(self._part(fn, state, sched, k, len(sched[0]), samp1, logp0))
        return torch.stack([o[0] for o in out]).sum(), sum(o[1] for o in out)


def run(cell, run):
    import gru4rec_tpu_torch.models.gru4rec as program
    import gru4rec_tpu_torch.train.step as program_step

    c, t, dev = cell.config, cell.traffic, run.device
    P = c["params"]
    data = clicks(cell, run)
    items, offsets = generators.sessions_csr(data)
    pop = np.bincount(items, minlength=int(c["n_items"]))
    events_per_epoch = len(items) - (len(offsets) - 1)
    n_check = int(t["checked_steps"])
    negs = draw_negatives(np.random.default_rng(run.stream("negatives")), pop,
                          float(P["sample_alpha"]), n_check, int(P["n_sample"]))
    wseed, pseed = run.stream("weights"), run.stream("program")
    model = common.program_model(cell, weights.make_params(c, wseed, dev), pseed, dev)
    window_epochs = max(1, round(run.seconds / float(t["nominal_epoch_s"])))
    probe = Probe(model, negs, int(t["traced_steps"]) if run.trace else 0, dev)

    saved = (program.make_chunk_fn, program_step.draw_negatives)
    program.make_chunk_fn = probe.wrap(saved[0])
    program_step.draw_negatives = probe.wrap_draw(saved[1])
    common.reset_peak(dev)
    try:
        with common.quiet():
            model.fit(data, n_epochs=1 + window_epochs, retrain=True)
        end = common.now()
    finally:
        program.make_chunk_fn, program_step.draw_negatives = saved
    peak = common.memory_peak(dev)
    if dev.type == "cuda":
        run.card_after = common.card_state()
    if probe.drawn is None:
        raise RuntimeError("the window's first chunk drew no negatives through "
                           "train.step.draw_negatives")

    stats_ = model.epoch_stats
    done = stats_[1:]
    # an epoch that never ended (a NaN abort) or trained other events failed
    failed = window_epochs - len(done) + sum(
        1 for f in done if f.get("events") != events_per_epoch)
    starts = probe.epoch_starts()[1:]
    run.window = [starts[0], end] if starts else [end, end]
    seconds = run.window[1] - run.window[0]
    metrics = {"train_events_per_s": stats.rate(events_per_epoch * len(done), seconds)
               if done else 0.0, "setup_s": run.setup_s()}
    # the step time each window epoch read (PERF.md: two step times)
    info = {"step_ms": [round((b - a) / f["steps"] * 1e3, 4)
                        for a, b, f in zip(starts, starts[1:] + [end], done)],
            "events_per_epoch": events_per_epoch, "window_epochs": window_epochs}
    prog_out = {"costs": probe.costs, "grad_norms": probe.grad_norms, "after": probe.after}
    drawn = probe.drawn.cpu().numpy()
    region, traced = probe.region, probe.traced
    del model, probe
    common.free(dev)

    # the reference, from the same inputs
    rnd = ref.ROUNDINGS[c["program"]["compute_dtype"]]
    numbers = compare.train_numbers(prog_numbers(prog_out, c, wseed, dev),
                                    reference_numbers(c, wseed, pseed, items, offsets, pop,
                                                      negs, rnd, dev))
    numbers["sampler_gap"] = compare.sampler_gap(drawn, pop, float(P["sample_alpha"]))
    layer = None
    if region is not None:
        layer = {"kind": "train", "region": region, "config": c, "traffic": t, **traced}
    return {"metrics": metrics, "attempted": events_per_epoch * window_epochs,
            "failed": failed * events_per_epoch, "memory_peak_bytes": peak,
            "numbers": numbers, "layer": layer, "info": info}


def prog_numbers(prog, config, wseed, device):
    p0 = weights.flat(weights.make_params(config, wseed, device))
    return {"costs": prog["costs"], "grad_norms": prog["grad_norms"],
            "change_norms": {k: float((prog["after"][k].to(device) - p0[k]).double().norm())
                             for k in LEAVES}}


def reference_numbers(config, wseed, pseed, items, offsets, pop, negs, rnd, device,
                      trainer_cls=ref.Trainer):
    """The reference's costs, first-gradient norms and change norms over
    the checked steps."""
    import torch

    ref.strict_float32()
    p0 = weights.flat(weights.make_params(config, wseed, device))
    cfg = {**config["params"], **config["program"]}
    trainer = trainer_cls(cfg, p0, pop, rnd, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(pseed)
    walk = ref.LaneWalk(items, offsets, int(cfg["batch_size"]))
    costs, grad_norms = [], None
    for t in range(len(negs)):
        inputs, targets, live, fresh = walk.step()
        cost, grads = trainer.step(inputs, targets, live, fresh,
                                   torch.from_numpy(negs[t].astype(np.int64)), gen)
        costs.append(cost)
        if t == 0:
            grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
    change = {k: float((trainer.P[k] - p0[k]).double().norm()) for k in LEAVES}
    return {"costs": costs, "grad_norms": grad_norms, "change_norms": change}
