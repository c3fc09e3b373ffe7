#!/usr/bin/env bash
# The PyTorch port's gate: the twin of scripts/ci.sh, with its stage
# numbering. It runs on a host with an NVIDIA card; without one it stops
# before stage 1 unless given --cpu.
#
# 1. the port's CPU tests — tests/test_torch_*.py without the card tests
#    (the parity tests hold each module of src/repro_torch to the JAX
#    package on the same numpy inputs, so they need jax on the CPU: where
#    jax is missing the stage is NOT RUN, said so on its own line, and the
#    later stages go on);
# 2. the card tests (timed) — tests/test_torch_gpu.py: every CUDA kernel
#    built with nvcc and held to its plain PyTorch version, the stores,
#    models and process groups on the card;
# 3. static lint — scripts/lint_plans_torch.py: the seeded-violation
#    fixtures first (each must trip its stable CC code), then the sweep of
#    every config, app superstep, merge function and serving store, its
#    programs run on the card;
# 4. benchmark gate — NOT in this script yet: it comes with the port's
#    benchmark twins and their gates (ROADMAP queue 1 item 1), which read
#    the port's own record stream against a baseline taken on the H100;
# 5. fault-tolerance gate — examples/fault_tolerant_train_torch.py --chaos
#    --quick on the card: the toy preemption/kill sweeps recovered
#    bitwise, the volatile-spec/CC040 audit, the elastic restore onto
#    another topology, the KV journal + snapshot recovered onto 2x shards,
#    and the real-model deferred run killed mid-cycle, resumed bitwise.
#
# --cpu runs stages 3 and 5 with --device cpu and does not run stage 2,
# saying so: a card run is never replaced by a CPU one without a word.
set -euo pipefail
cd "$(dirname "$0")/.."

cpu=0
for arg in "$@"; do
    case "$arg" in
        --cpu) cpu=1 ;;
        *) echo "usage: scripts/ci_torch.sh [--cpu]" >&2; exit 2 ;;
    esac
done

export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
if [ "$cpu" = 1 ]; then
    device=cpu
elif python -c 'import sys, torch; sys.exit(not torch.cuda.is_available())'
then
    device=cuda
else
    echo "ci_torch.sh: no CUDA card on this host; pass --cpu to run" \
         "stages 1, 3 and 5 on the CPU (stage 2 needs the card)" >&2
    exit 2
fi

if JAX_PLATFORMS=cpu python -c 'import jax' 2>/dev/null; then
    echo "=== stage 1: the port's CPU tests ==="
    JAX_PLATFORMS=cpu python -m pytest -x -q tests/test_torch_*.py -m "not gpu"
else
    echo "=== stage 1: the port's CPU tests NOT RUN (no jax on this host:" \
         "they hold the port to the JAX package) ==="
fi

if [ "$device" = cuda ]; then
    echo "=== stage 2: card tests (timed) ==="
    time python -m pytest -q -m gpu tests/test_torch_gpu.py
else
    echo "=== stage 2: card tests NOT RUN (--cpu: they need a card) ==="
fi

echo "=== stage 3: static plan lint (--device $device) ==="
python scripts/lint_plans_torch.py --fixtures --device "$device"
python scripts/lint_plans_torch.py --device "$device"

echo "=== stage 4: benchmark gate NOT RUN (not ported yet:" \
     "ROADMAP queue 1 item 1) ==="

echo "=== stage 5: fault-tolerance gate (--device $device) ==="
python examples/fault_tolerant_train_torch.py --chaos --quick \
    --device "$device"
