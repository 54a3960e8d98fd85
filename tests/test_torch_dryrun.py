"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, and its counts against what the policy's code issues.

Every fake-process-group run is a process of its own
(``tests/torch_dryrun_cells.py``; the group is global), and so is JAX's
side, which forces 8 host devices (importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` and a compilation cache for the whole process). They start
together, after the timed production cell:

  * JAX's mini dry-run (``tests/test_distributed_subprocess.py``'s
    ``test_mini_dryrun_mesh_2x2x2``): reduced gemma2-27b,
    granite-moe-1b-a400m and mamba2-370m, the train shape ("t", 64, 8) on a
    (2, 2, 2) mesh. Each cell's ``attn_mode``, ``sharding_fallbacks``,
    ``microbatches``, ``chips`` and ``model_flops_global_6ND`` equal JAX's,
    its stats finite and positive. The attention archs run at head dim 64
    in both packages: ``reduced()`` sets 16, which the card's flash
    backward kernel does not take, and the meta path follows the card.
  * on a (1, 4) mesh, granite's step in 8 microbatches, two traced (the
    second weighted by 7) against all traced: the same counts; and a
    reduced yi-9b
    decode in "head_dim" mode: per layer
    (2 layers less 1) the four collectives ``model._attn_sharded`` names,
    rope's partner exchange and the all-reduces of the scores, of ``wo``
    and of the MLP's output.
  * ``python -m repro_torch.launch.dryrun --arch yi-9b --shape prefill_32k
    --mesh single``, full width and depth, writes its JSON within 30 s.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from torch_dryrun_cells import MINI_ARCHS, MINI_HEAD_DIM

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")

JAX_MINI = """
    import dataclasses, json, jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeConfig
    from repro.launch import specs
    from repro.launch.dryrun import build_step
    from repro.models.model import build_model
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2),
                ("pod", "data", "model"))
    shape = ShapeConfig("t", 64, 8, "train")
    out = {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        if cfg.head_dim:
            cfg = dataclasses.replace(cfg, head_dim=HEAD_DIM)
        policy, parallel = specs.make_policy(cfg, shape, mesh)
        model = build_model(cfg, mesh, parallel, policy)
        args, aux = specs.input_specs(cfg, shape, policy, model)
        fn, extra = build_step(cfg, shape, mesh, policy, parallel, model,
                               aux)
        fn.lower(*args)      # the trace records the policy's fallbacks
        out[arch] = {
            "attn_mode": policy.mode,
            "sharding_fallbacks": [list(map(str, f))
                                   for f in policy.fallbacks],
            "microbatches": extra["microbatches"],
            "chips": int(mesh.devices.size),
            "model_flops_global_6ND": 6.0 * cfg.active_param_count()
            * shape.global_batch * shape.seq_len}
    print(json.dumps(out))
"""


def _start(args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, str(TESTS)])
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=TESTS)


def _json(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:] + "\n" + err[-5000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    t0 = time.time()
    cli = _start(["-m", "repro_torch.launch.dryrun", "--arch", "yi-9b",
                  "--shape", "prefill_32k", "--mesh", "single", "--out",
                  str(out_dir)])
    cli_out, cli_err = cli.communicate(timeout=300)
    cli_s = time.time() - t0
    assert cli.returncode == 0, cli_out[-3000:] + "\n" + cli_err[-5000:]
    jax_code = textwrap.dedent(JAX_MINI).replace(
        "ARCHS", repr(MINI_ARCHS)).replace("HEAD_DIM", str(MINI_HEAD_DIM))
    procs = {
        "mini": _start(["-m", "torch_dryrun_cells", "mini"]),
        "1x4": _start(["-m", "torch_dryrun_cells", "on_1x4"]),
        "jax": _start(["-c", jax_code], {
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "JAX_PLATFORMS": "cpu"}),
    }
    out = {k: _json(p) for k, p in procs.items()}
    out["cli"] = {"seconds": cli_s, "stdout": cli_out,
                  "result": json.loads(
                      (out_dir / "yi-9b__prefill_32k__single.json")
                      .read_text())}
    return out


def _finite_positive(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_mini_dryrun_matches_jax(runs, arch):
    pytest.importorskip("jax")
    got, want = runs["mini"][arch], runs["jax"][arch]
    for key in ("attn_mode", "sharding_fallbacks", "microbatches", "chips"):
        assert got[key] == want[key], key
    assert got["roofline"]["model_flops_global_6ND"] == \
        want["model_flops_global_6ND"]
    stats, roof = got["hlo_stats"], got["roofline"]
    for x in (stats["flops"], stats["dot_flops"], stats["hbm_bytes"],
              stats["collectives"]["wire_bytes"],
              got["memory_analysis"]["peak_bytes_per_device"],
              roof["compute_s"], roof["memory_s"], roof["collective_s"],
              roof["useful_flops_ratio"], roof["roofline_fraction"]):
        assert _finite_positive(x), (arch, x)
    kernel = "ssd_intra_chunk" if arch == "mamba2-370m" else \
        "flash_attention"
    # the family's kernel, forward and backward, on each rank's heads
    calls = stats["kernels"]["calls"][kernel]
    assert calls["fwd"] > 0 and calls["bwd"] > 0


def test_weighted_microbatches_count_as_every_microbatch(runs):
    one = runs["1x4"]
    assert one["microbatches"] == 8
    assert one["weighted"] == one["unweighted"]
    assert one["weighted"]["kernel_calls"]["grouped_matmul"]["dx"] > 0


def test_head_dim_decode_counts_four_collectives_a_layer(runs):
    one, two = runs["1x4"]["decode_1"], runs["1x4"]["decode_2"]
    assert one["attn_mode"] == two["attn_mode"] == "head_dim"
    per = {k: two["collectives"]["per_op"][k]["count"]
           - one["collectives"]["per_op"].get(k, {"count": 0})["count"]
           for k in two["collectives"]["per_op"]}
    # the scores', wo's and the MLP's all-reduces; rope's exchange
    assert per == {"all-reduce": 3, "collective-permute": 1}


def test_production_cell_writes_its_json_within_30s(runs):
    """The cell's own time from building its model to its JSON (the
    process's start, torch's import among it, runs ~5 s more here and
    stretches under a loaded test run)."""
    cli = runs["cli"]
    r = cli["result"]
    took = r["timings_s"]["build"] + r["timings_s"]["trace"]
    assert took < 30, (took, cli["seconds"])
    assert "[ok] yi-9b__prefill_32k__single" in cli["stdout"]
    for key in ("arch", "shape", "mesh", "variant", "chips", "attn_mode",
                "sharding_fallbacks", "timings_s", "memory_analysis",
                "hlo_stats", "roofline"):
        assert key in r, key
    assert set(r["timings_s"]) == {"build", "trace"}
    assert set(r["roofline"]) >= {
        "compute_s", "memory_s", "collective_s", "dominant",
        "model_flops_global_6ND", "model_flops_per_device",
        "useful_flops_ratio", "roofline_fraction"}
    assert r["chips"] == 256 and r["memory_analysis"]["fits_device"]
    # 48 layers, one flash call each on the rank's q heads
    assert r["hlo_stats"]["kernels"]["calls"] == {
        "flash_attention": {"fwd": 48}}


def test_local_step_counts_the_kernels_on_meta():
    """``dryrun.local_step``, the unsharded step ``chip_smoke.py`` counts on
    meta and on the card: a prefill's flash call a layer, and a train step's
    forward (twice a layer under remat "full"), backward and the MoE's
    grouped matmuls, at the mini configs' head dim 64."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import analyze_step
    from torch_dryrun_cells import mini_config
    yi = dataclasses.replace(mini_config("yi-9b"), num_layers=3)
    _, stats = analyze_step(*_call(dryrun.local_step(yi, "prefill", 2, 32,
                                                     "meta")))
    assert stats.kernel_calls == {"flash_attention": {"fwd": 3}}
    granite = dataclasses.replace(mini_config("granite-moe-1b-a400m"),
                                  remat_policy="full")
    _, stats = analyze_step(*_call(dryrun.local_step(granite, "train", 2, 32,
                                                     "meta")))
    n = granite.num_layers
    assert stats.kernel_calls == {
        "flash_attention": {"fwd": 2 * n, "bwd": n},
        "grouped_matmul": {"fwd": 6 * n, "dx": 3 * n, "dw": 3 * n}}
    assert stats.memory["peak_bytes"] > stats.memory["argument_bytes"] > 0


def _call(step):
    fn, args = step
    return (fn, *args)
