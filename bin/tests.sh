#!/bin/bash
# Single golden-diff test — port of the reference's bin/tests.sh:
#   tests.sh NP VARIANT N
# The reference's grid was NP ranks x CPUs-per-proc (OpenMP threads); here
# intra-device parallelism is always on, so the second axis becomes the KERNEL
# VARIANT — the implementation matrix the build actually has:
#   trig   — XLA kernel, reference trig force decomposition (parity path)
#   fast   — XLA kernel, transcendental-free rsqrt path
#   pallas — Pallas Triton kernel (interpreted on the CPU)
# Each variant is oracled by its own --devices=1 run (re-partitioning
# invariance, the reference's correctness property); the trig oracle is
# additionally diffed against the vendored golden fixture when one exists.
# Numeric VARIANT values (the reference's CPUs arg) are accepted as "trig".
set -u
. "$(dirname "$0")/common.sh"

NP="${1:?usage: tests.sh NP VARIANT N}"
VARIANT="${2:?usage: tests.sh NP VARIANT N}"
N="${3:?usage: tests.sh NP VARIANT N}"
STEPS="${STEPS:-1000}"

case "$VARIANT" in
  trig|[0-9]*) VARIANT=trig; FLAGS="" ;;
  fast)        FLAGS="--fast" ;;
  pallas)      FLAGS="--pallas" ;;
  *) echo "unknown variant: $VARIANT (trig|fast|pallas)" >&2; exit 2 ;;
esac

ARENA=$(ensure_arena)
mkdir -p "$REPO_ROOT/tests_out"
# The cached oracle is STEPS-specific: the default keeps the reference's
# tests/${N}_MY_REF_OUTPUT naming; other step counts get their own file so
# a STEPS=100 run never diffs against a stale 1000-step oracle.
if [ "$STEPS" = 1000 ]; then
  REF="$REPO_ROOT/tests_out/${N}_${VARIANT}_MY_REF_OUTPUT"
else
  REF="$REPO_ROOT/tests_out/${N}_${VARIANT}_s${STEPS}_MY_REF_OUTPUT"
fi
BASE="$REPO_ROOT/tests_out/${NP}_${VARIANT}_${N}_mynbody.test"

if [ ! -f "$REF" ]; then
  # Generate into a temp file and only cache on success: a crashed or
  # interrupted oracle run must not leave an empty REF that makes every
  # later run of this combo diff-FAIL forever.
  if ! nbody_cpu "$N" 0 "$ARENA" "$STEPS" --devices=1 $FLAGS \
      > "$REF.tmp" 2>/dev/null || [ ! -s "$REF.tmp" ]; then
    rm -f "$REF.tmp"
    echo "ORACLE GENERATION FAILED: N=$N VARIANT=$VARIANT STEPS=$STEPS" >&2
    exit 3
  fi
  mv "$REF.tmp" "$REF"
  # The parity variant's oracle must itself match the vendored golden
  # fixture (reference tests/${N}_MY_REF_OUTPUT semantics).
  GOLD="$REPO_ROOT/tests/fixtures/${N}_MY_REF_OUTPUT"
  if [ "$VARIANT" = trig ] && [ "$STEPS" = 1000 ] && [ -f "$GOLD" ]; then
    if ! diff -q "$GOLD" "$REF" >/dev/null; then
      echo "ORACLE MISMATCH: $REF != $GOLD" >&2
    fi
  fi
fi

nbody_cpu "$N" 0 "$ARENA" "$STEPS" --devices="$NP" $FLAGS \
  > "$BASE.out" 2> "$BASE.err"
if diff "$REF" "$BASE.out" > "$BASE.diff"; then
  echo "STATUS=PASSED" >> "$BASE.out"
else
  echo "Status=FAILED" >> "$BASE.out"
fi
