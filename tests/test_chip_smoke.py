"""chip_smoke.py on the CPU: every phase's control flow and comparisons at
tiny sizes (the device numbers come only from a run on the GPU), and the
script's refusal to report a result anywhere but on a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")

TINY = {
    "fixed": dict(seconds=2.0, check_frames=4096, chunk_target=8192,
                  check_chunk_target=2048, G=2),
    "interpolated": dict(rows=4, chunk_target=2048, chunks=4),
    "asrc": dict(S=16, n=2048, sentinels=4),
    "f64_chain": dict(chunk_target=8192, chunks=3),
    "packed": dict(chunk_target=4096, G=2),
    "cli": dict(seconds=2.0, artest_seconds=2),
}


@pytest.fixture
def cpu_limits(monkeypatch):
    """XLA:CPU's f32 dot accumulates sequentially, which puts the f32 round
    trip near -135 dB here; int8's two_sum combine is f32-class on the CPU
    (CLAUDE.md).  The f64-accumulate mode keeps the device bound."""
    monkeypatch.setitem(cs.ROUNDTRIP_LIMIT_DB, "f32", -130.0)
    monkeypatch.setitem(cs.ROUNDTRIP_LIMIT_DB, "int8", -130.0)


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_passes_at_tiny_size(name, cpu_limits):
    clock = cs.PhaseClock()
    out = cs.PHASES[name](clock, **TINY[name])
    json.dumps(out, default=float)
    assert clock.rows
    for row in clock.rows.values():
        assert row["cold"]["wall_s"] > 0 and row["warm"]["wall_s"] > 0


def test_phase_four_on_virtual_devices():
    import jax
    out = cs.phase_four(None, devices=jax.devices()[:4], seconds=1.0, S=16,
                        n=2048, pipeline_blocks=64)
    assert out["pipeline_4x1"]["exact_bytes"]
    assert set(out) == {"art_4x1", "art_2x2", "asrc_4x1", "pipeline_4x1"}


def test_phase_four_needs_four_devices():
    import jax
    with pytest.raises(cs.SmokeFailure, match="4 devices"):
        cs.phase_four(None, devices=jax.devices()[:2])


def test_fixed_phase_fails_past_its_limit(cpu_limits, monkeypatch):
    monkeypatch.setitem(cs.ROUNDTRIP_LIMIT_DB, "f32", -200.0)
    with pytest.raises(cs.SmokeFailure, match="fixed/f32: round trip"):
        cs.phase_fixed(None, **TINY["fixed"])


def test_require_gpu_refuses_the_cpu_backend():
    import jax
    with pytest.raises(cs.SmokeFailure, match="not 'gpu'"):
        cs.require_gpu(jax)


def test_stream_flat_out_matches_sequential_process():
    import jax.numpy as jnp
    from art_jax.parallel.streams import DeviceStreamResampler

    IB, _ = cs._flags()
    x = jnp.asarray(cs.artest_noise(30000, 2))
    a = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB)
    b = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB)
    for e in (a, b):
        e.advance_position(190)
    chunk = cs.mult_chunk(4000, a.M)
    got, Ks = cs.stream_flat_out(a, x, chunk, 3)
    outs, Kb = [], []
    pos = 0
    while pos < x.shape[1]:
        n = min(chunk, x.shape[1] - pos)
        o, K = b.process(x[:, pos:pos + n], n)
        outs.append(np.asarray(o)[:, :K])
        Kb.append(K)
        pos += n
    o, K = b.flush()
    outs.append(np.asarray(o)[:, :K])
    Kb.append(K)
    assert Ks == Kb
    np.testing.assert_allclose(np.asarray(got), np.concatenate(outs, 1),
                               atol=1e-6)


def test_artest_stats_parser():
    text = ("   input (-w1): count =    221184, checksum = 8b794f915c947a5a,"
            " range = -0.4999945 to 0.4999998, RMS = -7.89 dB\n"
            "    diff (-w5): count =    221184, checksum = bc88955adc1ac28b,"
            " range = -0.0000002 to 0.0000003, RMS = -142.77 dB\n")
    assert cs.artest_stats(text) == {
        "-w1": (221184, "8b794f915c947a5a", -7.89),
        "-w5": (221184, "bc88955adc1ac28b", -142.77)}


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_script_exits_nonzero_without_a_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, SCRIPT, *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
