"""End-to-end CLI tests — argv contract, stderr contract, golden diff,
checkpoint/resume, experiment CSV (nbody-seq.c:386-499 / nbody-par.c:768-978
behavior)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURE = os.path.join(REPO, "tests", "fixtures", "128_MY_REF_OUTPUT")


def run_cli(args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append("--xla_force_host_platform_device_count=8")
    env["XLA_FLAGS"] = " ".join(flags)
    if env_extra:
        env.update(env_extra)
    # The timeout guards against a rare XLA-CPU virtual-device dispatch hang
    # (environmental, observed ~1/50 runs).  One retry converts that known
    # nondeterministic hang into a pass (~1/2500 residual) while still
    # failing loudly on anything reproducible; subprocess.run kills the hung
    # child on timeout before the retry starts.
    cmd = [sys.executable, "-m", "parallel_nbody_tpu.cli"] + args
    for attempt in (1, 2):
        try:
            return subprocess.run(cmd, capture_output=True, text=True,
                                  env=env, cwd=REPO, timeout=600)
        except subprocess.TimeoutExpired:
            if attempt == 2:
                raise


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    from parallel_nbody_tpu.utils import ppm
    p = str(tmp_path_factory.mktemp("arena") / "nbody.ppm")
    ppm.create(p, 1024, 768)
    return p


def test_usage_error():
    r = run_cli(["3", "0"])
    assert r.returncode == 1
    assert "Usage:" in r.stderr


def test_stderr_contract_and_output(arena):
    r = run_cli(["32", "0", arena, "10"])
    assert r.returncode == 0
    assert "Running N-body with 32 bodies and 10 steps" in r.stderr
    assert "N-body took:" in r.stderr
    assert "Performance N-body:" in r.stderr
    assert len(r.stdout.splitlines()) == 32
    for line in r.stdout.splitlines():
        assert len(line.split()) == 6


def test_zero_steps_multi_device_prints_init(arena):
    # steps=0 must print the initial state (reference behavior) and be
    # shard-invariant — the sharded path's gather/unpad runs with no
    # compiled step program at all.
    a = run_cli(["16", "0", arena, "0"])
    b = run_cli(["16", "0", arena, "0", "--devices=4"])
    assert a.returncode == 0 and b.returncode == 0, b.stderr[-2000:]
    assert a.stdout == b.stdout
    assert len(a.stdout.splitlines()) == 16


def test_bodyct_clamping(arena):
    r = run_cli(["1", "0", arena, "1"])
    assert "Using two bodies..." in r.stderr
    assert len(r.stdout.splitlines()) == 2
    r = run_cli(["20000", "0", arena, "0"])
    assert "Using only 10000 bodies..." in r.stderr
    assert len(r.stdout.splitlines()) == 10000


def test_missing_ppm(arena):
    r = run_cli(["32", "0", "/nonexistent.ppm", "10"])
    assert r.returncode == 1
    assert "Cannot read" in r.stderr


@pytest.mark.slow
def test_golden_diff_via_cli(arena):
    r = run_cli(["128", "0", arena, "1000", "--devices=4"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == open(REF_FIXTURE).read()


def test_run_xps_csv(arena):
    # --devices=1 is the sequential-binary analog: NBODIES,RTIME,GFLOPS row.
    r = run_cli(["64", "0", arena, "5", "--run-xps", "--devices=1"])
    parts = r.stdout.strip().split(",")
    assert parts[0] == "64"
    assert float(parts[1]) >= 0

    r = run_cli(["64", "0", arena, "5", "--run-xps", "--devices=2"])
    parts = r.stdout.strip().split(",")
    # SIZE,NODES,CPUS_PER_NODE,NBODIES,RTIME,COMMTIME,RATIO,GFLOPS
    assert len(parts) == 8
    assert parts[0] == "2" and parts[3] == "64"


def test_measure_comm(arena):
    # --xps-precise: at the reference's %.3f a sub-0.5ms collective rounds
    # to 0.000 on a fast machine, making the positivity assert flaky.
    r = run_cli(["64", "0", arena, "20", "--run-xps", "--devices=2",
                 "--measure-comm", "--xps-precise"])
    parts = r.stdout.strip().split(",")
    assert float(parts[5]) > 0  # COMMTIME (real 2-device mesh collective)
    assert float(parts[6]) >= 0  # RATIO


def test_checkpoint_resume_bitexact(arena, tmp_path):
    ck = str(tmp_path / "state.npz")
    full = run_cli(["16", "0", arena, "200"])
    first = run_cli(["16", "0", arena, "100", f"--checkpoint={ck}"])
    assert full.returncode == 0, full.stderr[-2000:]
    assert first.returncode == 0, first.stderr[-2000:]
    assert os.path.exists(ck)
    second = run_cli(["16", "0", arena, "200", f"--resume={ck}"])
    assert second.stdout == full.stdout
    assert second.stdout != first.stdout


def test_checkpoint_resume_across_shard_counts(arena, tmp_path):
    # Resume is shard-topology-independent: checkpoint from a 4-way run,
    # resume on 2 shards, must match a straight single-device run.
    ck = str(tmp_path / "state.npz")
    full = run_cli(["16", "0", arena, "200", "--devices=1"])
    saved = run_cli(["16", "0", arena, "100", "--devices=4",
                     f"--checkpoint={ck}"])
    assert saved.returncode == 0, saved.stderr[-2000:]
    resumed = run_cli(["16", "0", arena, "200", "--devices=2",
                       f"--resume={ck}"])
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert resumed.stdout == full.stdout


def test_checkpoint_orbax_sharded_roundtrip(arena, tmp_path):
    """--checkpoint to a directory = Orbax written from the still-sharded
    state (no host gather); --resume restores straight into the run's
    sharding and stays bit-exact (VERDICT r2 #6)."""
    ck = str(tmp_path / "ckpt_dir")
    full = run_cli(["16", "0", arena, "200", "--devices=4"])
    first = run_cli(["16", "0", arena, "100", "--devices=4",
                     f"--checkpoint={ck}"])
    assert first.returncode == 0, first.stderr[-2000:]
    assert os.path.isdir(ck)
    resumed = run_cli(["16", "0", arena, "200", "--devices=4",
                       f"--resume={ck}"])
    assert resumed.stdout == full.stdout
    assert resumed.stdout != first.stdout


def test_checkpoint_orbax_resume_across_shard_counts(arena, tmp_path):
    # Orbax restore reshards on read: checkpoint from a 4-way run, resume
    # on 2 shards, must match a straight single-device run.
    ck = str(tmp_path / "ckpt_dir")
    full = run_cli(["16", "0", arena, "200", "--devices=1"])
    saved = run_cli(["16", "0", arena, "100", "--devices=4",
                     f"--checkpoint={ck}"])
    assert saved.returncode == 0, saved.stderr[-2000:]
    resumed = run_cli(["16", "0", arena, "200", "--devices=2",
                       f"--resume={ck}"])
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert resumed.stdout == full.stdout


def test_checkpoint_orbax_padding_mismatch_falls_back(arena, tmp_path):
    # N=20 on 4 shards pads to 20; resuming on 8 shards needs 24 — the
    # padded lengths differ, so the resume takes the host-restore + re-pad
    # fallback instead of the direct sharded restore.  Results must still
    # match an uninterrupted single-device run byte-for-byte.
    ck = str(tmp_path / "ckpt_dir")
    full = run_cli(["20", "0", arena, "160", "--devices=1"])
    saved = run_cli(["20", "0", arena, "80", "--devices=4",
                     f"--checkpoint={ck}"])
    assert saved.returncode == 0, saved.stderr[-2000:]
    resumed = run_cli(["20", "0", arena, "160", "--devices=8",
                       f"--resume={ck}"])
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert resumed.stdout == full.stdout


def test_checkpoint_orbax_mesh2d_resume(arena, tmp_path):
    # The 2-D decomposition restores through the host fallback (its state
    # layout is produced by shard_state_2d, not the 1-D body sharding).
    ck = str(tmp_path / "ckpt_dir")
    full = run_cli(["16", "0", arena, "160", "--devices=1"])
    saved = run_cli(["16", "0", arena, "80", "--mesh2d=2x4",
                     f"--checkpoint={ck}"])
    assert saved.returncode == 0, saved.stderr[-2000:]
    resumed = run_cli(["16", "0", arena, "160", "--mesh2d=2x2",
                       f"--resume={ck}"])
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert resumed.stdout == full.stdout


def test_resume_missing_path_fails_loudly(arena):
    r = run_cli(["16", "0", arena, "10", "--resume=/nonexistent/ck.npz"])
    assert r.returncode == 1
    assert "Cannot resume" in r.stderr
    assert "Traceback" not in r.stderr


def test_resume_corrupt_npz_fails_loudly(arena, tmp_path):
    # A truncated .npz raises EOFError (and a corrupted zip BadZipFile) from
    # numpy's loader — neither is an OSError, so the resume guard must catch
    # them explicitly or the user sees a raw traceback.
    ck = tmp_path / "ck.npz"
    saved = run_cli(["16", "0", arena, "5", f"--checkpoint={ck}"])
    assert saved.returncode == 0, saved.stderr[-2000:]
    trunc = tmp_path / "ck_trunc.npz"
    trunc.write_bytes(ck.read_bytes()[:40])
    r = run_cli(["16", "0", arena, "5", f"--resume={trunc}"])
    assert r.returncode == 1
    assert "Cannot resume" in r.stderr
    assert "Traceback" not in r.stderr
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"PK\x03\x04 not actually a zip archive")
    r2 = run_cli(["16", "0", arena, "5", f"--resume={garbage}"])
    assert r2.returncode == 1
    assert "Cannot resume" in r2.stderr
    assert "Traceback" not in r2.stderr


def test_resume_non_checkpoint_dir_fails_loudly(arena, tmp_path):
    # An existing directory that is NOT an Orbax checkpoint must produce the
    # friendly error, not an AttributeError from Orbax internals.
    junk = tmp_path / "junk"
    junk.mkdir()
    r = run_cli(["16", "0", arena, "10", "--devices=2",
                 f"--resume={junk}"])
    assert r.returncode == 1
    assert "Cannot resume" in r.stderr
    assert "Traceback" not in r.stderr


def test_checkpoint_orbax_overwrite_on_rerun(arena, tmp_path):
    # Re-running with the same --checkpoint directory must overwrite (the
    # .npz path's np.savez semantics), not crash after the simulation.
    ck = str(tmp_path / "ckpt_dir")
    first = run_cli(["16", "0", arena, "50", "--devices=2",
                     f"--checkpoint={ck}"])
    assert first.returncode == 0, first.stderr[-2000:]
    second = run_cli(["16", "0", arena, "100", "--devices=2",
                      f"--checkpoint={ck}"])
    assert second.returncode == 0, second.stderr[-2000:]
    resumed = run_cli(["16", "0", arena, "100", "--devices=2",
                       f"--resume={ck}"])
    # The checkpoint now holds the 100-step state: resuming at steps=100
    # runs zero further steps and must reproduce the second run's output.
    assert resumed.stdout == second.stdout


def test_frame_rendering_with_secsup(tmp_path):
    from parallel_nbody_tpu.utils import ppm
    p = str(tmp_path / "frame.ppm")
    ppm.create(p, 256, 192)
    r = run_cli(["8", "1", p, "3000"])
    assert r.returncode == 0
    px = ppm.read_pixels(ppm.read_header(p))
    assert px.any(), "expected at least one rendered frame with bodies"


def test_devices_request_exceeding_available_fails(arena):
    # make_mesh must refuse (not silently truncate) when the requested shard
    # count exceeds the devices present — a --devices=16 run on the 8-device
    # virtual mesh must error, not emit a CSV claiming 16 chips.
    r = run_cli(["32", "0", arena, "1", "--devices=16", "--run-xps"])
    assert r.returncode == 1
    assert "16-device mesh" in r.stderr
    assert r.stdout == ""


def test_unknown_flag(arena):
    r = run_cli(["32", "0", arena, "1", "--bogus"])
    assert r.returncode == 1
    assert "Unknown flag" in r.stderr


def test_openmp_flag_accepted(arena):
    r = run_cli(["8", "0", arena, "1", "--openmp"])
    assert r.returncode == 0


def test_mesh2d_golden_diff(arena):
    # 2-D force-matrix decomposition through the full CLI: byte-identical
    # to the golden fixture.
    r = run_cli(["128", "0", arena, "1000", "--mesh2d=2x4"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == open(REF_FIXTURE).read()


def test_mesh2d_bad_value(arena):
    r = run_cli(["32", "0", arena, "1", "--mesh2d=2x"])
    assert r.returncode == 1 and "Bad --mesh2d" in r.stderr
    r = run_cli(["32", "0", arena, "1", "--mesh2d=0x4"])
    assert r.returncode == 1 and "Bad --mesh2d" in r.stderr


def test_chunk_steps_matches_single_dispatch(arena):
    a = run_cli(["32", "0", arena, "100"])
    b = run_cli(["32", "0", arena, "100", "--chunk-steps=7"])
    assert b.returncode == 0, b.stderr[-2000:]
    assert a.stdout == b.stdout


def test_chunk_steps_bad_values(arena):
    # Advisor r2: non-positive / non-integer values must fail loudly at
    # parse time (a negative value used to hang the run loop forever).
    for bad in ("--chunk-steps=-3", "--chunk-steps=0", "--chunk-steps=x"):
        r = run_cli(["8", "0", arena, "1", bad])
        assert r.returncode == 1, bad
        assert "Bad --chunk-steps" in r.stderr


def test_par_csv_byte_contract(arena):
    """VERDICT r2 #7: the par CSV row must byte-match the reference format
    "%d,%d,%d,%d,%.3f,%.3f,%.3f,%.2f" (nbody-par.c:956 — 3 decimals on
    COMMTIME/RATIO, NO space before GFLOPS); --xps-precise opts into the
    6-decimal comm fields."""
    import re
    r = run_cli(["64", "0", arena, "5", "--run-xps", "--devices=2"])
    row = r.stdout.strip()
    assert re.fullmatch(
        r"\d+,\d+,\d+,\d+,\d+\.\d{3},\d+\.\d{3},\d+\.\d{3},\d+\.\d{2}",
        row), row

    r = run_cli(["64", "0", arena, "5", "--run-xps", "--devices=2",
                 "--xps-precise"])
    row = r.stdout.strip()
    assert re.fullmatch(
        r"\d+,\d+,\d+,\d+,\d+\.\d{3},\d+\.\d{6},\d+\.\d{6},\d+\.\d{2}",
        row), row

    # The seq row keeps its (reference-mandated) space before GFLOPS
    # (nbody-seq.c:488).
    r = run_cli(["64", "0", arena, "5", "--run-xps", "--devices=1"])
    assert re.fullmatch(r"\d+,\d+\.\d{3}, \d+\.\d{2}", r.stdout.strip())


def test_devices_flag_validated_at_parse_time(arena):
    """--devices must get the same friendly parse-time error surface as
    its sibling flags, not a bare int() ValueError traceback."""
    for bad in ("--devices=abc", "--devices=", "--devices=0"):
        r = run_cli(["16", "0", arena, "1", bad])
        assert r.returncode == 1, bad
        assert "Bad --devices" in r.stderr
        assert "Traceback" not in r.stderr


def test_dtype_flag_validated_at_parse_time(arena):
    r = run_cli(["16", "0", arena, "1", "--dtype=fp32"])
    assert r.returncode == 1
    assert "Bad --dtype" in r.stderr
    assert "Traceback" not in r.stderr


def test_mesh2d_devices_conflict_rejected(arena):
    """--mesh2d=RxC implies R*C devices; a conflicting explicit --devices
    must fail loudly instead of silently running on R*C devices."""
    r = run_cli(["16", "0", arena, "1", "--mesh2d=2x2", "--devices=8"])
    assert r.returncode == 1
    assert "conflicting --devices" in r.stderr
    # A consistent pair is accepted.
    r = run_cli(["16", "0", arena, "1", "--mesh2d=2x2", "--devices=4"])
    assert r.returncode == 0, r.stderr[-2000:]


def test_comm_flag_validated_at_parse_time(arena):
    """VERDICT r3 #3: --comm=bogus must get the same friendly parse-time
    error surface as --mesh2d / --chunk-steps, not an AssertionError
    traceback from deep inside the sharded runner."""
    r = run_cli(["16", "0", arena, "1", "--comm=bogus", "--devices=2"])
    assert r.returncode == 1
    assert "Bad --comm value" in r.stderr
    assert "Traceback" not in r.stderr


def test_positional_args_atoi_semantics(arena):
    """VERDICT r3 #3: the reference parses positionals with atol/atoi
    (nbody-seq.c:421-435) — non-numeric -> 0 -> the bodyCt<2 clamp path,
    not a ValueError traceback."""
    r = run_cli(["abc", "0", arena, "2"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Using two bodies..." in r.stderr
    assert len(r.stdout.splitlines()) == 2

    # atoi takes the leading numeric prefix: "12x" -> 12, "3.9" -> 3.
    r = run_cli(["12x", "0", arena, "3.9"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Running N-body with 12 bodies and 3 steps" in r.stderr


def test_atoi_unit():
    from parallel_nbody_tpu.cli import _atoi
    assert _atoi("123") == 123
    assert _atoi("  -42xyz") == -42
    assert _atoi("+7") == 7
    assert _atoi("abc") == 0
    assert _atoi("") == 0
    assert _atoi("-") == 0
    assert _atoi("3.9") == 3


def test_cadence_chunk_cap_unit():
    from parallel_nbody_tpu.cli import cadence_chunk_cap
    # Steps slower than secsup: check every step, like the reference.
    assert cadence_chunk_cap(1, 2.0) == 1
    assert cadence_chunk_cap(1, 1.0) == 1
    # 10 steps/sec at secsup=1 -> largest power of two <= 10.
    assert cadence_chunk_cap(1, 0.1) == 8
    assert cadence_chunk_cap(5, 0.001) == 4096
    # Degenerate probe readings never produce a non-positive chunk.
    assert cadence_chunk_cap(1, 0.0) >= 1


def test_frame_cadence_with_slow_steps(tmp_path):
    """VERDICT r3 #8: with secsup=1 at a slow-stepping N, frames must keep
    coming at least about every 2*secsup of wall time.  Two regressions are
    covered: (a) async dispatch — without a completion fence the loop queues
    every chunk in milliseconds and renders exactly one frame; (b) an
    uncapped chunk spacing the elapsed checks much wider than secsup."""
    from parallel_nbody_tpu.utils import ppm
    arena = str(tmp_path / "small.ppm")
    ppm.create(arena, 256, 192)  # small arena keeps each render cheap
    log = str(tmp_path / "frames.log")
    r = run_cli(["1500", "1", arena, "60"],
                env_extra={"NBODY_FRAME_LOG": log})
    assert r.returncode == 0, r.stderr[-2000:]
    import re
    rtime = float(re.search(r"N-body took: ([0-9.]+)", r.stderr).group(1))
    frames = 0
    if os.path.exists(log):
        with open(log) as f:
            frames = sum(1 for _ in f)
    if rtime >= 6.0:  # guard: on an implausibly fast box the run is too
        # short to discriminate; the unit test above still covers the cap.
        assert frames >= int(rtime / 2.0) - 1, (frames, rtime)


def test_install_smoke():
    """VERDICT r3 #9: pip-install the package (wheel, offline) and run the
    nbody-tpu console script on the parity config — byte-identical to the
    module entry point."""
    r = subprocess.run([os.path.join(REPO, "bin", "install-smoke.sh")],
                       capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, (r.stdout or "") + (r.stderr or "")
    assert "INSTALL_SMOKE_OK" in r.stdout


def test_frame_rendering_with_secsup_sharded(tmp_path):
    """secsup>0 on a SHARDED run: the per-chunk completion fence and the
    renderer both consume a device-sharded state — must not crash, must
    render, and stdout must stay byte-invariant vs single-device."""
    from parallel_nbody_tpu.utils import ppm
    p1 = str(tmp_path / "a.ppm")
    p4 = str(tmp_path / "b.ppm")
    ppm.create(p1, 256, 192)
    ppm.create(p4, 256, 192)
    log = str(tmp_path / "frames.log")
    single = run_cli(["64", "0", p1, "400"])
    assert single.returncode == 0, single.stderr[-3000:]
    sharded = run_cli(["64", "1", p4, "400", "--devices=4"],
                      env_extra={"NBODY_FRAME_LOG": log})
    assert sharded.returncode == 0, sharded.stderr[-3000:]
    assert sharded.stdout == single.stdout
    with open(log) as f:
        assert sum(1 for _ in f) >= 1
    px = ppm.read_pixels(ppm.read_header(p4))
    assert px.any()


def test_trace_flag_writes_profile_and_reports_share(arena, tmp_path):
    """--trace=DIR wraps the timed loop in a jax.profiler trace and reports
    the trace-derived collective share on stderr (the async-aware comm
    measurement, SURVEY.md §5) without altering stdout parity."""
    d = str(tmp_path / "trace")
    plain = run_cli(["32", "0", arena, "20", "--devices=4"])
    assert plain.returncode == 0, plain.stderr[-3000:]
    traced = run_cli(["32", "0", arena, "20", "--devices=4",
                      "--trace=" + d])
    assert traced.returncode == 0, traced.stderr[-3000:]
    assert traced.stdout == plain.stdout
    assert "Trace: op time" in traced.stderr, traced.stderr[-3000:]
    import glob
    assert glob.glob(os.path.join(d, "**", "*.trace.json.gz"),
                     recursive=True)


def test_trace_flag_empty_value_rejected(arena):
    r = run_cli(["16", "0", arena, "1", "--trace="])
    assert r.returncode == 1
    assert "Bad --trace value" in r.stderr
