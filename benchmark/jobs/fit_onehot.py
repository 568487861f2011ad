"""Training the one-hot model: :mod:`benchmark.jobs.fit`'s job for a
configuration whose input is the one-hot vector (``constrained_embedding``
false, ``embedding`` 0), whose ``Wx[0]`` is an item table updated row by
row beside ``Wy``.

The run is ``fit``'s: one ``GRU4Rec.fit`` call of ``1 + E`` epochs over
:func:`fit.clicks`, epoch 1 set-up, epochs 2 .. E + 1 the window, watched
through :class:`fit.Probe`, whose subclass :class:`Probe` reads adagrad's
accumulators after step 1 where this model keeps them: ``Wh``, ``Wrz``
and ``Bh`` in the dense state, ``Wx[0]`` (``Wx0``) and ``Wy`` in the
sparse one. The weights are :mod:`benchmark.yardstick.weights_onehot`'s and
the reference :mod:`benchmark.reference.gru4rec_onehot`'s; the numbers
compared are ``fit``'s (``loss_gap``, ``grad_gap``, ``change_gap`` over
``Wx``, ``Wh``, ``Wrz``, ``Bh`` and ``Wy``, and ``sampler_gap``).

With tracing, the layer also holds what the K4 readers need of the traced
steps: each live step's raw positions and valid positions of ``Wx0``'s
update, its distinct valid rows, the table's width and the state's row
layout (``metrics/sparse_update_k4_roofline.py``). ``info`` adds the
program's launch counters over the ``fit`` call (``launches_by_mode``: the
row-sparse kernel by mode, the bfloat16 products by direction; on the card
a replayed step counts its captured launches).
"""

from __future__ import annotations

import numpy as np

from benchmark.jobs import common, fit
from benchmark.reference import gru4rec as ref
from benchmark.reference import gru4rec_onehot as ref_onehot
from benchmark.yardstick import compare, generators, stats, weights, weights_onehot

DENSE_STATE = ("Wh", "Wrz", "Bh")
SPARSE_STATE = {"Wx": "Wx0", "Wy": "Wy"}  # leaf: the program's sparse state name


def accumulators(opt_state) -> dict:
    """adagrad's accumulator of each leaf, in the program's state."""
    acc = {k: opt_state["dense"][k][0]["acc"] for k in DENSE_STATE}
    acc.update({k: opt_state["sparse"][name]["acc"] for k, name in SPARSE_STATE.items()})
    return acc


class Probe(fit.Probe):
    """:class:`fit.Probe` for the one-hot model: the accumulators after step 1
    from both state groups, and the K4 inputs of the traced steps."""

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
                self.grad_norms = {k: float(torch.sqrt(a.double().sum()))
                                   for k, a in accumulators(state.opt_state).items()}
        self.after = {k: v.detach().cpu().clone()
                      for k, v in weights.flat(state.params).items()}
        ls, ec = self._part(fn, state, sched, n, len(sched[0]), samp1, logp0)
        return torch.stack(losses + [ls]).sum(), events + ec

    def _traced(self, fn, state, sched, samp1, logp0):
        out = super()._traced(fn, state, sched, samp1, logp0)
        k = min(self.trace_steps, len(sched[0]))
        in_c, valid_c = sched[0][:k], sched[2][:k].astype(bool)
        live = [t for t in range(k) if valid_c[t].any()]
        table = state.params["Wx"][0]
        self.traced["k4"] = {
            "positions": int(in_c.shape[1]),
            "valid": [int(valid_c[t].sum()) for t in live],
            "distinct_rows": [len(np.unique(in_c[t][valid_c[t]])) for t in live],
            "d": int(table.shape[1]),
            "adapt": str(self.model.config.adapt),
            "state": {name: [int(v.shape[1]), int(v.element_size())]
                      for name, v in state.opt_state["sparse"]["Wx0"].items()}}
        return out


def launch_counts():
    """The program's launch counters by mode (copies)."""
    from gru4rec_tpu_torch.ops import mixed_mm
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    return {"sparse_update": dict(sparse_update.launches_by_mode),
            "mixed_mm": dict(mixed_mm.launches_by_mode)}


def run(cell, run):
    import gru4rec_tpu_torch.models.gru4rec as program
    import gru4rec_tpu_torch.train.step as program_step

    c, t, dev = cell.config, cell.traffic, run.device
    P = c["params"]
    data = fit.clicks(cell, run)
    items, offsets = generators.sessions_csr(data)
    pop = np.bincount(items, minlength=int(c["n_items"]))
    events_per_epoch = len(items) - (len(offsets) - 1)
    n_check = int(t["checked_steps"])
    negs = fit.draw_negatives(np.random.default_rng(run.stream("negatives")), pop,
                              float(P["sample_alpha"]), n_check, int(P["n_sample"]))
    wseed, pseed = run.stream("weights"), run.stream("program")
    model = common.program_model(cell, weights_onehot.make_params(c, wseed, dev), pseed, dev)
    window_epochs = max(1, round(run.seconds / float(t["nominal_epoch_s"])))
    probe = Probe(model, negs, int(t["traced_steps"]) if run.trace else 0, dev)

    saved = (program.make_chunk_fn, program_step.draw_negatives)
    program.make_chunk_fn = probe.wrap(saved[0])
    program_step.draw_negatives = probe.wrap_draw(saved[1])
    launches_before = launch_counts()
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
    launches = {kind: {m: n - launches_before[kind][m] for m, n in counts.items()}
                for kind, counts in launch_counts().items()}

    done = model.epoch_stats[1:]
    # an epoch that never ended (a NaN abort) or trained other events failed
    failed = window_epochs - len(done) + sum(
        1 for f in done if f.get("events") != events_per_epoch)
    starts = probe.epoch_starts()[1:]
    run.window = [starts[0], end] if starts else [end, end]
    seconds = run.window[1] - run.window[0]
    metrics = {"train_events_per_s": stats.rate(events_per_epoch * len(done), seconds)
               if done else 0.0, "setup_s": run.setup_s()}
    info = {"step_ms": [round((b - a) / f["steps"] * 1e3, 4)
                        for a, b, f in zip(starts, starts[1:] + [end], done)],
            "events_per_epoch": events_per_epoch, "window_epochs": window_epochs,
            "launches_by_mode": launches}
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
    p0 = weights.flat(weights_onehot.make_params(config, wseed, device))
    return {"costs": prog["costs"], "grad_norms": prog["grad_norms"],
            "change_norms": {k: float((prog["after"][k].to(device) - p0[k]).double().norm())
                             for k in fit.LEAVES}}


def reference_numbers(config, wseed, pseed, items, offsets, pop, negs, rnd, device,
                      trainer_cls=ref_onehot.Trainer):
    """The reference's costs, first-gradient norms and change norms over
    the checked steps."""
    import torch

    ref.strict_float32()
    p0 = weights.flat(weights_onehot.make_params(config, wseed, device))
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
    change = {k: float((trainer.P[k] - p0[k]).double().norm()) for k in fit.LEAVES}
    return {"costs": costs, "grad_norms": grad_norms, "change_norms": change}
