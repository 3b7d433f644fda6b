"""The port's training substrate against the JAX package on the CPU:
optimizers, gradient compression, the placement-aware input pipeline,
sharded checkpoints and their manager, the fault-tolerant runner and the
train CLI.

* AdamW, Adafactor (factored state), the cosine schedule, global-norm
  clipping and the int8 round trip: the same numpy inputs through both,
  within 1e-6;
* the pipeline: batches, hosts, ``avg_span`` and ``idle_host_fraction``
  bit for bit over 10 steps with hosts dying, slowing and recovering;
* checkpoints: round trip (bf16 leaves included), keep-k, a lost shard,
  and the manager's ``restore_span`` equal to the reference's;
* the runner's restart from a checkpoint and the straggler detector;
* ``python -m repro_torch.launch.train --device cpu`` at the reference
  e2e test's arguments prints ``improved`` and the failure event.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.data import PlacementAwarePipeline as RefPipeline
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import cosine_schedule as ref_cosine
from repro.optim.compression import int8_compress as ref_int8_compress
from repro.optim.compression import int8_decompress as ref_int8_decompress
from repro_torch import flags
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.data import PlacementAwarePipeline
from repro_torch.optim import (adafactor, adamw, apply_error_feedback,
                               clip_by_global_norm, cosine_schedule,
                               int8_compress, int8_decompress,
                               make_optimizer)
from repro_torch.runtime import (FaultTolerantRunner, StepFailure,
                                 StragglerDetector)
from repro_torch.tree import tree_leaves, tree_map

jax = pytest.importorskip("jax")
jnp = jax.numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- optimizers
def _tree_np(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (6, 8), "stack": (2, 5, 4), "b": (7,), "s": ()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    ref_opt = {"adamw": ref_adamw, "adafactor": ref_adafactor}[name](3e-2)
    opt = make_optimizer(name, 3e-2)
    p_np = _tree_np(0, SHAPES)
    ref_p = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    ref_st, st = ref_opt.init(ref_p), opt.init(p)
    for i in range(5):
        g_np = _tree_np(10 + i, SHAPES)
        ref_u, ref_st = ref_opt.update(
            {k: jnp.asarray(v) for k, v in g_np.items()}, ref_st, ref_p)
        u, st = opt.update({k: torch.from_numpy(v) for k, v in g_np.items()},
                           st, p)
        for k in SHAPES:
            np.testing.assert_allclose(u[k].numpy(), np.asarray(ref_u[k]),
                                       **TOL)
        ref_p = jax.tree.map(lambda a, b: a + b, ref_p, ref_u)
        p = tree_map(lambda a, b: a + b, p, u)
    assert int(st.step) == int(ref_st.step) == 5
    assert st.step.dtype == torch.int32
    for field in st._fields[1:]:
        for k in SHAPES:
            np.testing.assert_allclose(
                getattr(st, field)[k].numpy(),
                np.asarray(getattr(ref_st, field)[k]), **TOL)


def test_adafactor_state_is_factored():
    st = adafactor(0.1).init({"w": torch.zeros((64, 128)),
                              "b": torch.zeros((7,))})
    assert st.vr["w"].shape == (64,) and st.vc["w"].shape == (128,)
    assert st.v["b"].shape == (7,) and st.v["w"].shape == ()


def test_adamw_keeps_bf16_parameters_and_fp32_moments():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    opt = adamw(1e-2)
    st = opt.init(p)
    u, st = opt.update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)},
                       st, p)
    assert u["w"].dtype == torch.bfloat16
    assert st.m["w"].dtype == st.v["w"].dtype == torch.float32


def test_cosine_schedule_matches_reference():
    ref, lr = ref_cosine(2.0, 10, 100), cosine_schedule(2.0, 10, 100)
    for step in (0, 3, 10, 11, 55, 99, 100, 150):
        want = pytest.approx(float(ref(step)), rel=1e-6, abs=1e-6)
        assert float(lr(step)) == want
        assert float(lr(torch.tensor(step, dtype=torch.int32))) == want


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g_np = _tree_np(4, SHAPES)
    ref_g, ref_n = ref_clip({k: jnp.asarray(v) for k, v in g_np.items()},
                            max_norm)
    g, n = clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g_np.items()}, max_norm)
    assert float(n) == pytest.approx(float(ref_n), rel=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(ref_g[k]), **TOL)
    bf = clip_by_global_norm({"a": torch.ones(4, dtype=torch.bfloat16)}, 1.0)
    assert bf[0]["a"].dtype == torch.bfloat16


def test_int8_round_trip_matches_reference():
    x = (np.random.default_rng(0).standard_normal(1000) * 3).astype(
        np.float32)
    ref_q, ref_s = ref_int8_compress(jnp.asarray(x))
    q, s = int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                    np.asarray(ref_q))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), **TOL)
    y = int8_decompress(q, s, x.shape, x.size)
    ref_y = ref_int8_decompress(ref_q, ref_s, x.shape, x.size)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
    assert float((y - torch.from_numpy(x)).abs().max()) <= \
        float(s.max()) * 0.51
    g = {"a": torch.ones(3)}
    assert apply_error_feedback(g, None) is g
    fed = apply_error_feedback(g, {"a": torch.full((3,), 0.5)})
    assert torch.equal(fed["a"], torch.full((3,), 1.5))


# ------------------------------------------------------------------ pipeline
PIPE = dict(num_shards=64, num_hosts=8, vocab_size=1000, batch_size=4,
            seq_len=32)


def test_pipeline_matches_reference_bit_for_bit():
    ref, pipe = RefPipeline(**PIPE), PlacementAwarePipeline(**PIPE,
                                                            device="cpu")
    assert np.array_equal(ref.plan.member, pipe.plan.member)
    events = {2: ("mark_dead", 3), 4: ("mark_slow", 5),
              6: ("mark_recovered", 3), 8: ("mark_recovered", 5)}
    for step in range(10):
        if step in events:
            name, host = events[step]
            getattr(ref, name)(host)
            getattr(pipe, name)(host)
        want, got = ref.next_batch(), pipe.next_batch()
        assert got["hosts"] == want["hosts"]
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
        if step in (2, 3):
            assert 3 not in got["hosts"]
    assert pipe.span_log == ref.span_log
    assert pipe.avg_span() == ref.avg_span()
    assert pipe.idle_host_fraction() == ref.idle_host_fraction()
    assert [(s.reads, s.bytes) for s in pipe.host_stats] == \
        [(s.reads, s.bytes) for s in ref.host_stats]


def test_pipeline_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PlacementAwarePipeline(**PIPE)


# ---------------------------------------------------------------- checkpoint
def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.float32),
                       "list": [torch.randn((3,), generator=g).to(
                           torch.bfloat16), torch.tensor(7, dtype=torch.int32)]},
            "step_scalar": torch.ones(())}


def test_checkpoint_round_trip_keeps_dtypes(tmp_path):
    state = _state()
    manifest = save_checkpoint(str(tmp_path / "c"), state, step=7,
                               num_shards=3)
    assert "bfloat16" in manifest["dtypes"]
    restored, step = load_checkpoint(str(tmp_path / "c"), state,
                                     device="cpu")
    assert step == 7
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not os.path.exists(str(tmp_path / "c") + ".tmp")
    with pytest.raises(NotImplementedError, match="9.6"):
        load_checkpoint(str(tmp_path / "c"), state, shardings=[],
                        device="cpu")


def test_checkpoint_keep_k_and_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, num_shards=2,
                            async_save=False, device="cpu")
    for s in (10, 20, 30):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [20, 30]
    restored, step = mgr.restore_latest(_state())
    assert step == 30 and torch.equal(restored["w"], _state(30)["w"])


def test_checkpoint_detects_lost_shard(tmp_path):
    save_checkpoint(str(tmp_path / "c"), _state(), step=1, num_shards=4)
    os.remove(str(tmp_path / "c" / "shard_00001.npz"))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "c"), _state(), device="cpu")


def test_restore_span_matches_reference(tmp_path):
    kw = dict(num_shards=16, num_storage_nodes=4, replication=2,
              async_save=False)
    restore_sets = [np.arange(i, i + 4) % 16 for i in range(0, 16, 4)]
    restore_sets += [np.array([0, 5, 10, 15]), np.array([1, 2, 9])]
    ref = RefCheckpointManager(str(tmp_path / "ref"), **kw)
    ref.save(1, {"w": jnp.zeros(3)}, restore_sets=restore_sets)
    mgr = CheckpointManager(str(tmp_path / "port"), **kw, device="cpu")
    mgr.save(1, _state(), restore_sets=restore_sets)
    assert np.array_equal(mgr.replica_plan.member, ref.replica_plan.member)
    assert [mgr.restore_span(rs) for rs in restore_sets] == \
        [ref.restore_span(rs) for rs in restore_sets]
    assert mgr.replica_plan.survives_failures(1)


def test_async_save_failure_is_raised(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    mgr.save(1, {"w": object()})
    with pytest.raises(RuntimeError, match="infer dtype"):
        mgr.wait()
    mgr.wait()   # raised once


# -------------------------------------------------------------------- runner
def test_runner_restarts_from_checkpoint(tmp_path):
    pipe = PlacementAwarePipeline(**PIPE, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=3, num_shards=2,
                            async_save=False, device="cpu")
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 12:   # worker dies mid-run, after a checkpoint
            raise StepFailure("simulated accelerator loss")
        return {"w": state["w"] + 1}, {"loss": 0.0}

    runner = FaultTolerantRunner(step_fn, {"w": torch.zeros(())}, pipe, mgr,
                                 ckpt_every=5)
    result = runner.run(20)
    assert result["steps"] == 20 and result["restarts"] == 1
    assert float(runner.state["w"]) == 20.0
    assert result["events"] == [(11, "step_failure:simulated accelerator "
                                 "loss")]


def test_runner_avoids_a_straggler():
    det = StragglerDetector(8, min_samples=2, threshold=2.0)
    for _ in range(3):
        for h in range(1, 8):
            det.observe(h, 0.1)
    assert det.observe(0, 1.0) is False  # first sample
    assert det.observe(0, 1.0) is True   # now clearly slow
    pipe = PlacementAwarePipeline(**PIPE, device="cpu")
    runner = FaultTolerantRunner(lambda s, b: (s, {}), {}, pipe, None)
    runner.straggler = det
    runner.report_host_latency(0, 1.0)
    assert runner.events == [(0, "straggler_avoided:0")]
    assert 0 in pipe.slow_hosts and 0 not in pipe.next_batch()["hosts"]


# ------------------------------------------------------------ the train CLI
def test_train_cli_improves_on_cpu(tmp_path):
    # one intra-op thread: under a parallel test run each torch process
    # would otherwise take a thread per core, and the copies together run
    # the CLI many times slower than one alone
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--reduced", "--device", "cpu", "--steps", "60",
         "--batch", "8", "--seq", "64", "--lr", "3e-3", "--ckpt-every",
         "25", "--inject-failures", "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    assert "(improved)" in proc.stdout
    assert "event@0: input_host_dead:0" in proc.stdout
    assert "steps=60 restarts=0" in proc.stdout
    assert any(d.startswith("step_") for d in os.listdir(tmp_path / "ckpt"))


def test_train_cli_refuses_the_mesh_flags():
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="9.6"):
        train.main(["--arch", "olmo-1b", "--mesh", "2x4", "--device", "cpu"])
    flags.reset()
