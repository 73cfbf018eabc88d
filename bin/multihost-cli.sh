#!/bin/bash
# Full-CLI multi-process launch — the exact analog of running the
# reference's nbody-par under prun/mpirun: NPROCS processes (2 virtual CPU
# devices each) join one jax.distributed runtime, run the complete CLI with
# the body axis sharded over the GLOBAL mesh, and rank 0 prints the final
# state / CSV.  Usage: multihost-cli.sh [NPROCS] [N] [STEPS] [extra flags...]
# Rank stdout is filtered of the gloo backend's "[Gloo] Rank N ..." banners
# so the captured output diffs cleanly against the sequential oracle.
set -u -o pipefail
. "$(dirname "$0")/common.sh"

NPROCS="${1:-2}"
N="${2:-64}"
STEPS="${3:-100}"
shift $(( $# > 3 ? 3 : $# ))
PORT="${PORT:-9877}"
ARENA=$(ensure_arena)
NDEV=$((NPROCS * 2))

pids=()
for PID in $(seq 0 $((NPROCS - 1))); do
  COORDINATOR_ADDRESS="localhost:$PORT" \
  NBODY_NUM_PROCESSES="$NPROCS" \
  NBODY_PROCESS_ID="$PID" \
  JAX_PLATFORMS=cpu \
  XLA_FLAGS="--xla_force_host_platform_device_count=2" \
  python -m parallel_nbody_tpu.cli "$N" 0 "$ARENA" "$STEPS" \
    --devices="$NDEV" "$@" | sed '/^\[Gloo\]/d' &
  pids+=($!)
done

rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=1
done
exit "$rc"
