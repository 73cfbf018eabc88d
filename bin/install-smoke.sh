#!/usr/bin/env bash
# Package-install smoke (VERDICT r3 #9): prove `pip install -e .` and the
# `nbody-tpu` console script (pyproject.toml [project.scripts]) actually
# work — the packaging surface is otherwise exercised only via PYTHONPATH.
#
# Builds and installs the wheel into a throwaway --prefix (offline:
# --no-build-isolation/--no-deps; a REGULAR install, not editable — .pth
# editable finders are not processed on PYTHONPATH entries), then runs the
# INSTALLED entry point with the repo stripped from PYTHONPATH — imports
# must resolve through the installed copy — and byte-diffs the output
# against `python -m parallel_nbody_tpu.cli` on the parity config.
set -euo pipefail
. "$(dirname "$0")/common.sh"

PFX="${1:-/tmp/nbody_install_smoke_prefix}"
ARENA="$(ensure_arena /tmp/install_smoke_arena.ppm)"
PYDIR="$(python -c 'import sys; print("python%d.%d" % sys.version_info[:2])')"

rm -rf "$PFX"
pip install -q "$REPO_ROOT" --no-build-isolation --no-deps --prefix "$PFX"
rm -rf "$REPO_ROOT/build" "$REPO_ROOT"/*.egg-info  # in-tree build residue

test -x "$PFX/bin/nbody-tpu"

out_installed=$(cd /tmp && env -u PYTHONPATH \
  PYTHONPATH="$PFX/lib/$PYDIR/site-packages" JAX_PLATFORMS=cpu \
  "$PFX/bin/nbody-tpu" 24 0 "$ARENA" 10 2>/dev/null)
out_module=$(cd /tmp && JAX_PLATFORMS=cpu \
  python -m parallel_nbody_tpu.cli 24 0 "$ARENA" 10 2>/dev/null)

if [ "$out_installed" = "$out_module" ] && [ -n "$out_installed" ]; then
  echo "INSTALL_SMOKE_OK (24 bodies x 10 steps byte-identical via installed console script)"
else
  echo "INSTALL_SMOKE_FAILED" >&2
  diff <(printf '%s\n' "$out_installed") <(printf '%s\n' "$out_module") >&2 || true
  exit 1
fi
