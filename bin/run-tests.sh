#!/bin/bash
# Test sweep — port of the reference's bin/run-tests.sh grid (NP in 1..8 x
# CPUs-per-proc in {1,4,16} = 24 combos).  Here the grid is NP shards in 1..8
# x kernel variant in {trig, fast, pallas} = 24 combos: re-partitioning
# invariance must hold for every implementation path, not just the default
# one.  Reports failures at the end.
set -u
BIN="$(dirname "$0")"
N="${N:-128}"
VARIANTS="${VARIANTS:-trig fast pallas}"

for VARIANT in $VARIANTS; do
  for NP in 1 2 3 4 5 6 7 8; do
    echo "== NP=$NP VARIANT=$VARIANT N=$N =="
    "$BIN/tests.sh" "$NP" "$VARIANT" "$N" "$@"
  done
done

"$BIN/failed-tests.sh"
