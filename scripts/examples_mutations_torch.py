"""Do ``chip_smoke.py`` ``phase_examples``' checks catch a wrong kernel?

    PYTHONPATH=src python scripts/examples_mutations_torch.py            # card
    PYTHONPATH=src python scripts/examples_mutations_torch.py --device cpu

Serves the quickstart's and serve_batched's twins at their defaults, then
serves the same weights and prompts again with one kernel wrapper of
``repro_torch.kernels.ops`` made subtly wrong (the model's kernel path
calls those wrappers; its plain path does not):

* ``decode_drops_newest``: ``decode_attention`` over slots ``[0,
  position - 1]``, the newest token's slot left out;
* ``flash_q_times_1.05``: ``flash_attention`` with its queries 5 % too
  large (a softmax scale off by 5 %);
* ``scan_y_times_1.02``: ``selective_scan``'s output 2 % too large (hymba
  alone: the quickstart's model has no scan);
* ``scatter_drops_last``: the embedding backward's ``cscatter`` without its
  last id (on the quickstart's trained weights and first microbatch).

Each wrong serve goes through ``_examples_plain_check`` and the wrong
scatter through ``_embedding_backward_check``; beside each verdict stands
that of the fixed rule the phase used before (logits within LOGIT_TOL,
greedy tokens where the margin exceeds twice it). Prints one JSON line and
exits 1 if a wrong kernel passes the phase's checks or a sound one fails
them. The quickstart's hot softmax sits at the limit: it moves the trained
model's logits by 1.8-6.0 % of their spread, by the PyTorch it trained on,
against a limit of 2 %.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode_drops_newest(orig):
    def f(q, k, v, position):
        return orig(q, k, v, max(position - 1, 0))
    return f


def _flash_q_times(orig):
    def f(q, k, v, causal=True, window=0):
        return orig(q * 1.05, k, v, causal=causal, window=window)
    return f


def _scan_y_times(orig):
    def f(*args):
        y, h = orig(*args)
        return y * 1.02, h
    return f


def _scatter_drops_last(orig):
    def f(table_grad, ids, grads):
        return orig(table_grad, ids[:-1], grads[:-1])
    return f


# name -> (the ops wrapper it replaces, its wrong version, the examples)
SERVE_MUTATIONS = {
    "decode_drops_newest": ("decode_attention", _decode_drops_newest,
                            ("quickstart", "serve_batched")),
    "flash_q_times_1.05": ("flash_attention", _flash_q_times,
                           ("quickstart", "serve_batched")),
    "scan_y_times_1.02": ("selective_scan", _scan_y_times,
                          ("serve_batched",)),
}
SCATTER_MUTATION = "scatter_drops_last"


@contextlib.contextmanager
def mutated(attr: str, wrong):
    """``repro_torch.kernels.ops.<attr>`` replaced by ``wrong(original)``."""
    from repro_torch.kernels import ops
    orig = getattr(ops, attr)
    setattr(ops, attr, wrong(orig))
    try:
        yield
    finally:
        setattr(ops, attr, orig)


def _old_rule(cs, model, batch, served, prompt: int) -> dict:
    model.impl = "plain"
    try:
        ref = cs._teacher_forced(model, batch, served, prompt)
    finally:
        model.impl = "kernel"
    worst, ok = 0.0, True
    for got, want in zip(served.logits, ref):
        err = float((got - want).abs().max())
        worst = max(worst, err)
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * cs.LOGIT_TOL
        ok = (ok and err <= cs.LOGIT_TOL
              and bool((got.argmax(-1) == want.argmax(-1))[sure].all()))
    return {"max_logit_err": worst, "passes": ok}


def _verdict(check) -> dict:
    """``check()``'s readings, or that it raised and why."""
    try:
        return {"caught": False, **check()}
    except RuntimeError as e:
        return {"caught": True, "why": str(e)[:300]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import batch_at, data_config_for
    from repro_torch.launch import steps
    from repro_torch.launch.serve import generate
    from repro_torch.serve.kv import resolve_device
    device = resolve_device(args.device)
    cs = _chip_smoke()
    qs = cs.load_example("quickstart_torch")
    sb = cs.load_example("serve_batched_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        q = qs.main(["--device", device.type])
        s = sb.main(["--device", device.type])
    runs = {"quickstart": (q["model"], {"tokens": q["prompt"]}, qs.PROMPT,
                           qs.GEN),
            "serve_batched": (s["model"], s["batch"],
                              len(s["batch"]["tokens"][0]), sb.GEN)}

    def serve_check(label):
        model, batch, prompt, gen = runs[label]
        served = generate(model, batch["tokens"], gen, keep_logits=True)
        return (lambda: cs._examples_plain_check(label, model, batch, served,
                                                 prompt),
                lambda: _old_rule(cs, model, batch, served, prompt))

    out = {"device": device.type, "sound": {}, "wrong": {}}
    for label in runs:
        new, _ = serve_check(label)
        out["sound"][label] = _verdict(new)
    dcfg = data_config_for(get_smoke_config(qs.ARCH), qs.SHAPE, seed=0)
    model = runs["quickstart"][0]

    def embedding_check():
        return cs._embedding_backward_check(
            steps.grads_fn(model), model.params(),
            steps.to_device(batch_at(dcfg, 0), device),
            rows=qs.SHAPE.global_batch // qs.MICROBATCHES)
    with contextlib.redirect_stdout(io.StringIO()):
        out["sound"]["quickstart_embedding_backward"] = _verdict(
            embedding_check)
    for name, (attr, wrong, labels) in SERVE_MUTATIONS.items():
        for label in labels:
            with mutated(attr, wrong):
                new, old = serve_check(label)
                out["wrong"][f"{name}/{label}"] = {"new_rule": _verdict(new),
                                                   "old_rule": old()}
    with mutated("embedding_grad_scatter", _scatter_drops_last), \
            contextlib.redirect_stdout(io.StringIO()):
        out["wrong"][f"{SCATTER_MUTATION}/quickstart_embedding_backward"] = {
            "new_rule": _verdict(embedding_check)}
    out["ok"] = (not any(v["caught"] for v in out["sound"].values())
                 and all(v["new_rule"]["caught"]
                         for v in out["wrong"].values()))
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
