"""Fault-tolerance demo on the port: NaN batches, preemption, kills, resume.

    PYTHONPATH=src python examples/fault_tolerant_train_torch.py       # demo
    PYTHONPATH=src python examples/fault_tolerant_train_torch.py --chaos
    PYTHONPATH=src python examples/fault_tolerant_train_torch.py \\
        --chaos --quick --device cpu

The PyTorch twin of ``examples/fault_tolerant_train.py``. The default is
the three-phase driver demo: train through a poisoned (NaN) batch, preempt
mid-run (a SIGTERM to this process, which ``runtime/driver.TrainDriver``
turns into a save at the step boundary and an exit from its run), restart
from the committed checkpoint.

``--chaos`` is the durability acceptance run for *deferred-commit* state
(``state["defer"]``: the pending cascade + an overlapped in-flight
launch), in the JAX example's order:

1. toy integer sweep — preemption at every step boundary and hard kills
   mid-cycle/mid-launch must recover bitwise-identically to the
   uninterrupted run (``repro_torch.runtime.chaos``);
2. volatile-spec audit — the checkpoint-coverage spec (CC040) must match
   the real defer state, key for key;
3. elastic restore — take a mid-cycle checkpoint onto a DIFFERENT merge
   topology: outstanding mass settles into params/opt (vs. the
   flush-under-old-topology oracle) and the defer-aware LR/beta rescale
   reports the hyperparameters that keep per-data-step dynamics fixed;
4. serving tier — journal + snapshot a ShardedKV, crash it mid-epoch,
   recover onto a different shard count, and match the numpy oracle
   bitwise;
5. real-model deferred train (xlstm-125m's smoke config over 8 stacked
   ranks, where the JAX example forces an 8-device host mesh; overlapped
   K=2 cascade) — kill the driver between steps, resume, and compare
   params bitwise against the uninterrupted twin.

Everything runs on ``--device`` (the card by default, raising without
one). The demo's weights are random from seed 0, or ``main(params=)``'s
JAX ``split_params`` tree.
"""

from __future__ import annotations

import argparse
import os
import signal
import tempfile

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.data.pipeline import batch_at, data_config_for
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build_model, from_jax_params
from repro_torch.optim import adamw, constant
from repro_torch.runtime import DriverConfig, TrainDriver
from repro_torch.runtime import chaos
from repro_torch.serve.kv import resolve_device

TOY_PLAN = "chip:2,host:2:defer,pod:2:defer"
# the demo: the steps before the preemption, the step boundary after them
# at which it comes, the steps after the resume
DEMO_STEPS, DEMO_PREEMPT_AFTER, DEMO_RESUME_STEPS = 8, 2, 5
# --chaos: the serving part's ticks (--quick, full) and its recovered
# store's commit period; the real model's steps and kill points (--quick,
# full)
SERVE_TICKS, SERVE_COMMIT = (12, 24), 2
REAL_STEPS, REAL_KILLS = 5, ([2], [1, 2, 3, 4])


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chaos", action="store_true",
                   help="run the deferred-state durability acceptance suite")
    p.add_argument("--quick", action="store_true",
                   help="with --chaos: fewer kill points / smaller sweeps "
                        "(the CI configuration)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def demo(device, say, params=None) -> dict:
    cfg = get_smoke_config("internlm2_1_8b")
    shape = ShapeConfig("ft", 32, 4, "train")
    model = (build_model(cfg, device=device, seed=0) if params is None
             else from_jax_params(cfg, params, device=device))
    opt = adamw(constant(1e-3))
    step_fn = make_train_step(model, cfg, opt, 1)
    params = model.params()
    state0 = {"params": params, "opt": opt.init(params)}
    dcfg = data_config_for(cfg, shape, seed=0)

    def batch_fn(i):
        b = dict(batch_at(dcfg, i))
        b["poison"] = float("nan") if i == 4 else 0.0
        return b

    def step_fn_injected(state, b):
        b = dict(b)
        poison = b.pop("poison")
        new_state, metrics = step_fn(state, b)
        # injected fault: emulate a corrupt batch poisoning the loss
        return new_state, dict(metrics, loss=metrics["loss"] + poison)

    out = {}
    with tempfile.TemporaryDirectory() as d:
        drv = TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=5,
                                       retry_backoff_s=0.0),
                          step_fn=step_fn_injected, batch_fn=batch_fn)

        say("phase 1: train through a poisoned batch")
        state, end = drv.run(state0, 0, DEMO_STEPS)
        nans = [e for e in drv.events if e["event"] == "nan_rollback"]
        out.update(reached=end, skipped=len(nans))
        say(f"  reached step {end}; skipped {len(nans)} poisoned batch")

        say("phase 2: preempt mid-run (SIGTERM)")
        drv2 = TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=100),
                           step_fn=step_fn_injected, batch_fn=batch_fn)

        def preempting(i):
            if i == end + DEMO_PREEMPT_AFTER:
                # TrainDriver's handler (installed for its run, on the
                # main thread) asks for a save at the next boundary
                _check(signal.getsignal(signal.SIGTERM) not in
                       (signal.SIG_DFL, None),
                       "the driver has no SIGTERM handler installed (it "
                       "installs one only on the main thread)")
                signal.raise_signal(signal.SIGTERM)
            return batch_fn(i)
        drv2.batch_fn = preempting
        state, _ = drv2.run(state, end, 20)
        out["preempted_at"] = ckpt.latest_step(d)
        say(f"  preempted; checkpoint committed at step "
            f"{out['preempted_at']}")

        say("phase 3: restart from the committed checkpoint")
        drv3 = TrainDriver(DriverConfig(ckpt_dir=d, ckpt_every=10),
                           step_fn=step_fn_injected, batch_fn=batch_fn)
        restored, start, _ = drv3.resume(state)
        state, end3 = drv3.run(restored, start, DEMO_RESUME_STEPS)
        losses = [e for e in drv3.events if e["event"] == "step"]
        out.update(resumed=(start, end3), final_loss=losses[-1]["loss"])
        say(f"  resumed {start} -> {end3}; "
            f"final loss {out['final_loss']:.4f}")
    return out


# ---------------------------------------------------------------------------
# --chaos: deferred-state durability acceptance
# ---------------------------------------------------------------------------


def chaos_toy_sweeps(quick: bool, device, say) -> dict:
    n_steps = 5 if quick else 8
    say(f"[toy] preempt at every boundary + kills, {n_steps} steps, "
        f"2-level overlapped cascade, integer ADD")
    fac = chaos.toy_factory(TOY_PLAN, (1, 2), 8, width=4, overlap=True,
                            device=device)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for mode in ("preempt", "kill"):
            kill_steps = ([1, 3] if quick else None)  # None = every boundary
            _, outcomes = chaos.chaos_sweep(
                fac, n_steps, os.path.join(root, mode), mode=mode,
                kill_steps=kill_steps)
            bad = [o for o in outcomes if not o.state_bitwise]
            _check(not bad, f"{mode}: non-bitwise recoveries {bad}")
            actions = sorted({o.resume_action for o in outcomes}, key=str)
            out[mode] = {"recovered": len(outcomes), "actions": actions}
            say(f"  {mode}: {len(outcomes)}/{len(outcomes)} boundaries "
                f"recovered bitwise (actions: {actions})")
        # flush policy: mass conserved (params bitwise for integer ADD),
        # optimizer fold count legitimately differs
        _, outcomes = chaos.chaos_sweep(
            fac, n_steps, os.path.join(root, "flush"), mode="preempt",
            defer_save="flush", kill_steps=[1, 3])
        _check(all(o.params_bitwise for o in outcomes),
               "flush policy: params not bitwise")
        say("  flush policy: params bitwise (mass conserved), "
            "opt sequencing differs as documented")
    return out


def chaos_spec_audit(device, say) -> dict:
    from repro_torch.analysis.durability import check_step_durability
    from repro_torch.checkpoint import tree_keys

    step, _, state0 = chaos.toy_factory(TOY_PLAN, (2, 4), 8, width=4,
                                        overlap=True, device=device)()
    spec = step.volatile_spec(state0["params"])
    _check(tree_keys(spec) == tree_keys(state0["defer"]),
           "volatile spec drifted from the real defer state")
    _check(not check_step_durability("example:toy", step, state0["params"]),
           "CC040: the checkpoint does not cover the volatile spec")
    leaves = len(tree_keys(spec))
    say(f"[spec] volatile spec == real defer state ({leaves} leaves); "
        f"CC040 clean")
    return {"leaves": leaves}


def chaos_elastic(device, say) -> dict:
    from repro_torch.runtime.elastic import (effective_invariants,
                                             rescale_hyperparams)

    say("[elastic] mid-cycle checkpoint restored onto a different "
        "topology (K=2 two-level overlap -> K=3 single-level)")
    fac_old = chaos.toy_factory(TOY_PLAN, (1, 2), 8, width=4, overlap=True,
                                device=device)
    fac_new = chaos.toy_factory("chip:4,pod:2:defer", (3,), 8, width=4,
                                device=device)
    with tempfile.TemporaryDirectory() as d:
        step_o, bf_o, st_o = fac_old()
        cfg = DriverConfig(ckpt_dir=d, ckpt_every=5)
        TrainDriver(cfg, step_o, bf_o, defer_step=step_o).run(st_o, 0, 5)

        # oracle: restore under the OLD topology, flush everything
        step_v, bf_v, like_v = fac_old()
        sv, _, _ = TrainDriver(cfg, step_v, bf_v,
                               defer_step=step_v).resume(like_v)
        sv, _ = step_v.flush(sv)

        # elastic: restore under the NEW topology — outstanding mass must
        # settle into params/opt, then fresh defer state is handed out
        step_n, bf_n, like_n = fac_new()
        drv_n = TrainDriver(cfg, step_n, bf_n, defer_step=step_n)
        sn, start, report = drv_n.resume(like_n)
        _check(report.action == "resolved", f"{report}")
        _check(bool((sn["params"]["w"] == sv["params"]["w"]).all()),
               "elastic settle lost mass")
        _check(int(sn["defer"]["t"]) == 0, "the new defer state is not fresh")
        h = rescale_hyperparams(report.k_old, report.k_new, lr=1e-3)
        inv_old = effective_invariants(report.k_old, lr=1e-3)
        inv_new = effective_invariants(report.k_new, **h)
        _check(np.allclose(inv_old["lr_per_step"], inv_new["lr_per_step"]),
               "the rescaled lr changes the per-data-step lr")
        sn, end = drv_n.run(sn, start, 3)
    say(f"  settled {report.flushed_steps} trailing step(s), "
        f"inflight={report.landed_inflight}; mass conserved bitwise; "
        f"continued {start}->{end} under K={report.k_new} with "
        f"lr'={h['lr']:.2e}, b1'={h['b1']:.4f} "
        f"(per-data-step lr invariant)")
    return {"flushed_steps": report.flushed_steps,
            "landed_inflight": report.landed_inflight, "k_new": report.k_new,
            "lr": h["lr"], "b1": h["b1"], "continued": (start, end)}


def chaos_serving(quick: bool, device, say) -> dict:
    from repro_torch.serve import KVConfig, ShardedKV, serving_plan

    S, B, R, D = 4, 8, 64, 2
    T = SERVE_TICKS[0] if quick else SERVE_TICKS[1]
    say(f"[serve] journal+snapshot a {S}-shard KV, crash mid-epoch, "
        f"recover onto {2 * S} partitioned shards")

    rng = np.random.default_rng(7)
    keys = rng.integers(0, R, (T, S, B)).astype(np.int32)
    keys[:, :, -1] = -1
    vals = rng.integers(1, 9, (T, S, B, D)).astype(np.int32)
    oracle = np.zeros((R, D), np.int64)
    for t in range(T):
        m = keys[t] >= 0
        np.add.at(oracle, keys[t][m], vals[t][m])
    oracle = oracle.astype(np.int32)

    with tempfile.TemporaryDirectory() as root:
        kv = ShardedKV(KVConfig(n_keys=R, cols=D), S, device=device,
                       commit_every=3)
        kv.attach_journal(root)
        for t in range(T // 2):
            kv.tick(keys[t], vals[t])
        kv.snapshot()
        for t in range(T // 2, T):
            kv.tick(keys[t], vals[t])
        del kv  # crash: every device buffer gone

        kv2 = ShardedKV(KVConfig(n_keys=R, cols=D, partitioned=True),
                        2 * S, device=device, plan=serving_plan(2 * S, "all"),
                        commit_every=SERVE_COMMIT)
        rep = kv2.recover(root)
        kv2.flush()
        _check(np.array_equal(kv2.table(), oracle),
               "recovered table != acknowledged history")
    say(f"  snapshot@{rep['snapshot_step']}, replayed "
        f"{rep['replayed_ticks']} journaled tick(s): table BITWISE "
        f"equal to the acknowledged update stream")
    return {"snapshot_step": rep["snapshot_step"],
            "replayed_ticks": rep["replayed_ticks"]}


def chaos_real_model(quick: bool, device, say) -> dict:
    n_steps = REAL_STEPS
    kill_points = REAL_KILLS[0] if quick else REAL_KILLS[1]
    say(f"[real] xlstm-125m, 8 stacked ranks, overlapped K=2 cascade; "
        f"kills at {kill_points} of {n_steps} steps")
    cfg = get_smoke_config("xlstm_125m")
    base = chaos.real_model_twin(cfg, n_steps, device=device)
    out = {}
    for kill in kill_points:
        with tempfile.TemporaryDirectory() as d:
            run = chaos.real_model_run(cfg, n_steps, d, kill, device=device)
        same = chaos.trees_bitwise_equal(run["state"]["params"],
                                         base["params"])
        _check(same, f"kill@{kill}: params diverged after recovery")
        report = run["report"]
        out[kill] = report.action if report else "fresh"
        say(f"  kill@{kill}: resumed ({out[kill]} at step "
            f"{report.step if report else 0}) -> params BITWISE equal")
    return out


def main(argv=None, *, params=None) -> dict:
    """The demo, or with ``--chaos`` the five parts; returns what it
    printed (``lines``) and each part's results. ``params`` (a JAX
    ``split_params`` tree) are the demo's weights."""
    args = _parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    if not args.chaos:
        return {"demo": demo(device, say, params), "lines": lines}
    out = {"toy": chaos_toy_sweeps(args.quick, device, say),
           "spec": chaos_spec_audit(device, say),
           "elastic": chaos_elastic(device, say),
           "serve": chaos_serving(args.quick, device, say),
           "real": chaos_real_model(args.quick, device, say)}
    say("CHAOS_SUITE_OK")
    out["lines"] = lines
    return out


if __name__ == "__main__":
    main()
