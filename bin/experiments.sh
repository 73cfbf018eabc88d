#!/bin/bash
# Parallel experiment sweep — port of the reference's bin/experiments.sh:
# REPLICATES x N in {512,1024,4096,10000} x shards in {2,4,6,8}, 100 steps,
# CSV appended under --run-xps. Pass --measure-comm to add the comm column,
# --fast for the fp32 speed path.  Rows byte-match the reference contract
# (nbody-par.c:956); pass --xps-precise for 6-decimal COMMTIME/RATIO (sub-ms
# collectives vanish at %.3f) — that mode defaults to a separate
# experiments_precise.csv.  Output: experiments.csv
set -u
. "$(dirname "$0")/common.sh"

REPLICATES="${REPLICATES:-3}"
STEPS="${STEPS:-100}"
DEFAULT_CSV="$REPO_ROOT/experiments.csv"
case " $* " in
  *" --xps-precise "*) DEFAULT_CSV="$REPO_ROOT/experiments_precise.csv" ;;
esac
CSV="${CSV:-$DEFAULT_CSV}"
ARENA=$(ensure_arena)

echo "SIZE,NODES,CPUS_PER_NODE,NBODIES,RTIME,COMMTIME,RATIO,GFLOPS" > "$CSV"
for rep in $(seq 1 "$REPLICATES"); do
  for N in 512 1024 4096 10000; do
    for NP in 2 4 6 8; do
      echo "rep=$rep N=$N NP=$NP" >&2
      nbody_cpu "$N" 0 "$ARENA" "$STEPS" --run-xps --devices="$NP" "$@" \
        >> "$CSV" 2>/dev/null
    done
  done
done
echo "wrote $CSV"
