# Shared harness helpers (sourced by the bin/ scripts).
# JAX analog of the reference's prun-based harness (bin/tests.sh etc.):
# "ranks" become --devices=K shards of the body axis; tests run on a virtual
# multi-device CPU mesh so they need no real multi-chip hardware.

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}"

NBODY="python -m parallel_nbody_tpu.cli"

# Virtual 8-device CPU mesh.
nbody_cpu() {
  # XLA flag parsing is last-occurrence-wins: strip any stale ambient
  # device-count flag and append ours LAST, or a leftover
  # --xla_force_host_platform_device_count=1 in the caller's environment
  # would shrink the required 8-device virtual mesh.
  local xla
  xla="$(printf '%s' "${XLA_FLAGS:-}" |
         sed -E 's/--xla_force_host_platform_device_count=[0-9]+//g')"
  JAX_PLATFORMS=cpu \
  XLA_FLAGS="$xla --xla_force_host_platform_device_count=8" \
  python -m parallel_nbody_tpu.cli "$@"
}

# Ensure an arena PPM exists (the reference ships a GIMP-made 1024x768 P6;
# we generate ours).
ensure_arena() {
  local path="${1:-$REPO_ROOT/nbody.ppm}"
  if [ ! -f "$path" ]; then
    # Status goes to stderr: callers capture this function's stdout as the
    # arena path ($(ensure_arena)), so it must stay a single line.
    python -c "
from parallel_nbody_tpu.utils import ppm
ppm.create('$path', 1024, 768)
" >&2
    echo "created $path (P6 1024x768)" >&2
  fi
  echo "$path"
}

# Cache-on-success golden-output generation from the reference binary: a
# crashed oracle run must not poison reruns (used by the fuzz harnesses).
# stdin comes from /dev/null so a caller's `while read` config stream can
# never be swallowed by the child.
#   fuzz_oracle REFBIN ARENA OUTDIR N STEPS   -> prints cached path; rc=1 on failure
fuzz_oracle() {
  # Named locals up front: the oracle invocation below reorders the
  # positional args, which is easy to miswire at call sites otherwise.
  local refbin="$1" arena="$2" outdir="$3" n="$4" steps="$5"
  local ref="$outdir/seq_${n}_${steps}.out"
  if [ ! -f "$ref" ]; then
    if ! "$refbin" "$n" 0 "$arena" "$steps" < /dev/null 2>/dev/null \
        > "$ref.tmp" || [ ! -s "$ref.tmp" ]; then
      rm -f "$ref.tmp"
      return 1
    fi
    mv "$ref.tmp" "$ref"
  fi
  echo "$ref"
}

# Shared scaffolding for the fuzz harnesses (fuzz-parity.sh, fuzz-resume.sh):
# resolve the oracle binary and artifact dir, SKIP cleanly when the reference
# checkout is absent, hand the reference binary a throwaway arena copy (it
# mmaps its PPM argument O_RDWR — map_P6, nbody-seq.c:171-304), and generate
# the config list up front so a broken generator fails loudly instead of
# feeding the loop zero lines and reporting a false green.
#   fuzz_setup KIND COUNT SEED DEFAULT_OUT_SUBDIR
# Sets REFBIN, OUT, CFGS.  Installs an EXIT trap that removes $CFGS plus
# whatever paths the caller has put in FUZZ_SCRATCH at that moment (e.g. an
# in-flight checkpoint when the run is interrupted mid-config).
fuzz_setup() {
  local kind="$1" count="$2" seed="$3" subdir="$4"
  REFBIN="${NBODY_REF_BIN:-/root/reference/nbody/nbody-seq}"
  # OUT is overridable so test runs don't clobber the committed sweep records
  # (whose .err files carry nondeterministic wall-clock timings).
  OUT="${NBODY_FUZZ_OUT:-$REPO_ROOT/tests_out/$subdir}"
  mkdir -p "$OUT"
  if [ ! -x "$REFBIN" ]; then
    echo "SKIPPED: reference binary not found at $REFBIN"
    exit 0
  fi
  local arena_src
  arena_src=$(ensure_arena)
  cp "$arena_src" "$OUT/arena.ppm"
  CFGS="$(mktemp "/tmp/fuzz_${kind}_configs.XXXXXX")" || exit 1
  # Bash array, expanded quoted in the trap: scratch paths include $OUT, so
  # an NBODY_FUZZ_OUT containing whitespace/glob characters must not
  # word-split or glob the rm -rf targets.
  FUZZ_SCRATCH=()
  trap 'rm -rf "$CFGS" "${FUZZ_SCRATCH[@]}"' EXIT
  if ! python "$REPO_ROOT/bin/fuzz_gen.py" "$kind" "$seed" "$count" > "$CFGS"
  then
    echo "CONFIG GENERATION FAILED (seed=$seed count=$count)"
    exit 1
  fi
}

# Count guard shared by the fuzz loops: a partially consumed config stream
# must fail the run even if every config that DID run passed.
#   fuzz_check_count RAN EXPECTED   -> rc=1 + message on mismatch
fuzz_check_count() {
  if [ "$1" -ne "$2" ]; then
    echo "CONFIG COUNT MISMATCH: ran $1 of $2"
    return 1
  fi
}

# Two-leg checkpoint/resume fuzz loop, shared by bin/fuzz-resume.sh (the
# sharding-axis stream) and bin/fuzz-resume-v2.sh (sharding + per-leg kernel
# stream — both generators emit the same N TOTAL SPLIT FMT F1 F2 line shape).
# Leg 1 runs to SPLIT under FLAGS1 and checkpoints; leg 2 resumes under the
# independently drawn FLAGS2 and continues to TOTAL.  BOTH legs' stdout must
# byte-match the reference binary's own uninterrupted runs at SPLIT and
# TOTAL steps (reference driver nbody-seq.c:386-499).
#   fuzz_resume_loop EXPECTED_COUNT    (consumes $CFGS; needs $REFBIN, $OUT)
fuzz_resume_loop() {
  local expected="$1" fail=0 ran=0
  local N TOTAL SPLIT FMT FLAGS1 FLAGS2 ref_k ref_s base ck ok1 ok2
  while read -r N TOTAL SPLIT FMT FLAGS1 FLAGS2; do
    FLAGS1="${FLAGS1//|/ }"
    FLAGS2="${FLAGS2//|/ }"
    if ! ref_k=$(fuzz_oracle "$REFBIN" "$OUT/arena.ppm" "$OUT" "$N" "$SPLIT") \
        || ! ref_s=$(fuzz_oracle "$REFBIN" "$OUT/arena.ppm" "$OUT" "$N" "$TOTAL")
    then
      echo "ORACLE GENERATION FAILED: N=$N steps=$SPLIT/$TOTAL"
      fail=1
      continue
    fi
    ran=$((ran + 1))
    # Leg shardings go into the basename (like fuzz-parity's $FLAGS) so two
    # configs sharing (N, TOTAL, SPLIT, FMT) can't clobber each other.
    base="$OUT/resume_${N}_${SPLIT}of${TOTAL}_${FMT}_$(
      printf '%s_%s' "$FLAGS1" "$FLAGS2" | tr ' =' '__')"
    ck="$base.ck"
    [ "$FMT" = npz ] && ck="$ck.npz"
    # Register the checkpoint with the EXIT trap (fuzz_setup) so an interrupt
    # mid-config can't leave un-ignored Orbax litter in the sweep directory.
    FUZZ_SCRATCH=("$base.ck" "$base.ck.npz")
    rm -rf "$base.ck" "$base.ck.npz"

    nbody_cpu "$N" 0 "$OUT/arena.ppm" "$SPLIT" $FLAGS1 --checkpoint="$ck" \
      < /dev/null > "$base.leg1.out" 2> "$base.leg1.err"
    nbody_cpu "$N" 0 "$OUT/arena.ppm" "$TOTAL" $FLAGS2 --resume="$ck" \
      < /dev/null > "$base.out" 2> "$base.err"

    # Both diffs run unconditionally: a leg1 mismatch must not leave a stale
    # or missing leg2 diff behind the FAILED pointer.
    diff "$ref_k" "$base.leg1.out" > "$base.leg1.diff"; ok1=$?
    diff "$ref_s" "$base.out" > "$base.diff"; ok2=$?
    if [ "$ok1" -eq 0 ] && [ "$ok2" -eq 0 ]; then
      echo "STATUS=PASSED" >> "$base.out"
      echo "PASSED N=$N split=$SPLIT/$TOTAL $FMT [$FLAGS1] -> [$FLAGS2]"
    else
      # Casing matches bin/tests.sh's marker, which bin/failed-tests.sh greps.
      echo "Status=FAILED" >> "$base.out"
      echo "FAILED N=$N split=$SPLIT/$TOTAL $FMT [$FLAGS1] -> [$FLAGS2]" \
           "(see $base.diff / $base.leg1.diff)"
      fail=1
    fi
    rm -rf "$base.ck" "$base.ck.npz"  # checkpoints are large and reproducible
    FUZZ_SCRATCH=()
  done < "$CFGS"

  fuzz_check_count "$ran" "$expected" || fail=1
  return "$fail"
}
