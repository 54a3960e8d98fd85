"""The Mamba2 and hybrid families served under a sharding policy on 4
gloo ranks on the CPU, float32, against the unsharded port and the JAX
package: reduced mamba2-370m (8 SSM heads) and zamba2-1.2b (its shared
attention block, 4 q heads over 2 kv heads) on (data 2, model 2) and
(data 1, model 4). ``d_inner`` and the SSM heads shard over ``model``
(4 or 2 heads a rank), the SSD op runs on each rank's heads with B and C
whole, the gated norm sums its squares over the ranks, the conv cache's x
shards by ``d_inner`` and the SSD state by its heads; zamba2's shared
block runs "heads" at (2, 2) and "expand" prefill, "head_dim" decode at
(1, 4). Each run prefills 4 x 40 tokens (off the 32-token chunk grid) to
max_seq 48 and decodes 6 steps fed JAX's greedy tokens, then 2 steps from
``init_cache`` (the serving test's steps, ``test_torch_sharded_serving``).
Their sharded train steps are in ``tests/test_torch_sharded_train.py``.
One spawn of the ranks (``tests/torch_dist_ranks.py``)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_dist_ranks as ranks  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from test_torch_sharded_serving import (B, MAX_SEQ, S, STEPS,  # noqa: E402
                                        _close, _jax_serve, _perturb)

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
RUNS = [(a, m) for a in ("mamba2-370m", "zamba2-1.2b") for m in MESHES]
IDS = [f"{a}-{m}" for a, m in RUNS]
# the shared block's modes (prefill, decode); the pure SSM has none
MODES = {("mamba2-370m", "2x2"): ("none", "none"),
         ("mamba2-370m", "1x4"): ("none", "none"),
         ("zamba2-1.2b", "2x2"): ("heads", "heads"),
         ("zamba2-1.2b", "1x4"): ("expand", "head_dim")}
# the SSD op's (x, B) shapes on a rank: its batch rows, 8 / tp heads of 16,
# B whole; flash's (q, k) for zamba2's shared block
LOCAL = {"2x2": {"ssd": ((2, S, 4, 16), (2, S, 16)),
                 "flash": ((2, S, 2, 16), (2, S, 1, 16))},
         "1x4": {"ssd": ((4, S, 2, 16), (4, S, 16)),
                 "flash": ((4, S, 1, 16), (4, S, 1, 16))}}


@pytest.fixture(scope="module")
def runs():
    """JAX's unsharded references here, then every run on the ranks."""
    refs, args = {}, []
    for arch, mesh in RUNS:
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        params, _ = JM.build_model(cfg).init(jax.random.PRNGKey(0))
        params = _perturb(jax.tree.map(np.asarray, params))
        toks = np.random.default_rng(3).integers(
            1, cfg.vocab_size, (B, S)).astype(np.int32)
        ref, feed = _jax_serve(cfg, params, toks)
        refs[arch, mesh] = (ref, feed)
        args.append({"arch": arch, "mesh": MESHES[mesh], "params": params,
                     "tokens": toks.astype(np.int64),
                     "feed": feed.astype(np.int64), "max_seq": MAX_SEQ,
                     "ref_key": arch})
    out, _ = run_ranks(ranks.serving_cases, 4, args=(args,), timeout=600)[0]
    return {run: (refs[run], res) for run, res in zip(RUNS, out)}


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_prefill_logits_and_caches(runs, run):
    """The last position's logits and every cache leaf (conv windows, SSD
    states, the shared block's K/V), gathered whole, against JAX and the
    unsharded port; the shared block's modes."""
    (ref, _), res = runs[run]
    got = res["sharded"]
    assert got["modes"][:2] == MODES[run]
    for name, want in (("jax", ref), ("port", res["port"])):
        _close(got["prefill"], want["prefill"], f"{name} prefill logits")
        _close(got["prefill_caches"], want["prefill_caches"],
               f"{name} prefill caches")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_decode_logits_caches_and_greedy_tokens(runs, run):
    """Six decode steps fed JAX's greedy tokens: each step's logits and the
    final caches against JAX and the unsharded port; the sharded argmax is
    the token JAX fed next."""
    (ref, feed), res = runs[run]
    got = res["sharded"]
    for name, want in (("jax", ref), ("port", res["port"])):
        for t in range(STEPS):
            _close(got["decode"][t], want["decode"][t],
                   f"{name} decode step {t}")
        _close(got["decode_caches"], want["decode_caches"],
               f"{name} decode caches")
    vocab = t_reduced(t_get_config(run[0])).vocab_size
    greedy = [got["prefill"][:, -1, :vocab].argmax(-1)] + [
        got["decode"][t][:, -1, :vocab].argmax(-1) for t in range(STEPS - 1)]
    np.testing.assert_array_equal(np.stack(greedy, 1), feed)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_decode_from_init_cache(runs, run):
    """Two steps from ``init_cache`` (DTensor zeros in ``abstract_cache``'s
    specs) against the unsharded port's."""
    res = runs[run][1]
    assert res["sharded"]["placed"]
    for t in range(2):
        _close(res["sharded"]["from_init"][t], res["port"]["from_init"][t],
               f"from init step {t}")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_each_kinds_model_runs_the_other_kinds_step(runs, run):
    """The decode-kind model's prefill and the prefill-kind model's first
    decode step on its own caches (zamba2's shared block "head_dim" and
    "expand" at (1, 4)) give the unsharded port's logits."""
    res = runs[run][1]
    _close(res["sharded"]["cross"][0], res["port"]["prefill"],
           "decode-kind prefill")
    _close(res["sharded"]["cross"][1], res["port"]["decode"][0],
           "prefill-kind decode")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_ssd_and_flash_run_on_each_ranks_shard(runs, run):
    """The SSD op sees this rank's batch rows and SSM heads with B and C
    whole; zamba2's flash op this rank's heads."""
    shapes = runs[run][1]["sharded"]["kernel_shapes"]
    want = LOCAL[run[1]]
    assert shapes["ssd"] == [want["ssd"]]
    assert shapes["flash"] == ([want["flash"]] if run[0] == "zamba2-1.2b"
                               else [])
