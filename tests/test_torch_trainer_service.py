"""The ``lm-trainer`` service in a VRE on provider ``cpu`` (reduced
widths, bf16 as the provider serves them), beside the JAX package's: the
quickstart flow (``examples/quickstart.py``) and the crash-restart flow
(``examples/elastic_restart.py``, on a transformer: SSM training is
ROADMAP A.7b), with the port's trainer started from JAX's state."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.core.services  # noqa: E402,F401
import repro_torch.core.services  # noqa: E402,F401
from repro.core.vre import VREConfig as JaxVREConfig  # noqa: E402
from repro.core.vre import \
    VirtualResearchEnvironment as JaxVRE  # noqa: E402
from repro_torch.core.vre import (VirtualResearchEnvironment,  # noqa: E402
                                  VREConfig)
from repro_torch.models.params import train_state_from_numpy  # noqa: E402

# bf16 params and activations round at other places in XLA and in torch,
# and every step rounds the params to bf16 again: five steps' losses
# agree to ~5e-4 relative (~0.02 of ~60)
RTOL = 2e-3


def _pair(tmp_path, arch, services, extra):
    kw = dict(name="t", mesh_shape=(1, 1), services=services, arch=arch,
              provider="cpu", extra=extra)
    jv = JaxVRE(JaxVREConfig(workdir=str(tmp_path / "jax"), **kw))
    tv = VirtualResearchEnvironment(VREConfig(workdir=str(tmp_path / "port"),
                                              **kw))
    return jv, tv


def test_quickstart_flow_matches_jax(tmp_path):
    services = ["volumes", "data", "lm-trainer", "workflows", "dashboard"]
    extra = {"global_batch": 4, "seq_len": 32, "workers": 4}
    jv, tv = _pair(tmp_path, "yi-9b", services, extra)
    jv.instantiate()
    tv.instantiate()
    try:
        jt, tt = jv.service("lm-trainer"), tv.service("lm-trainer")
        assert tt.health() and tt.metrics() == {"step": 0, "loss": None}
        tt.state = train_state_from_numpy(jax.tree.map(np.asarray, jt.state),
                                          "cpu")
        want = jt.train_steps(jv.service("data"), 5)
        got = tt.train_steps(tv.service("data"), 5)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert tt.metrics() == {"step": 5, "loss": got[-1]} and tt.health()
        logged = [e for e in tv.monitor.events() if e["event"] == "step"]
        assert [e["step"] for e in logged] == [1, 2, 3, 4, 5]
        tv.service("volumes").save(tt.state, step=5, blocking=True)
        assert tv.service("volumes").latest_step() == 5
        wf = tv.service("workflows").new("demo")
        wf.map_partitions("sumsq", lambda p: float((p ** 2).sum()),
                          np.arange(100, dtype=np.float64), 4, reducer=sum)
        assert tv.service("workflows").run(wf)["sumsq:gather"] == 328350.0
    finally:
        jv.destroy()
        tv.destroy()
    tv2 = VirtualResearchEnvironment(tv.config)
    tv2.instantiate()
    assert tv2.service("lm-trainer").health()
    tv2.destroy()


def test_crash_restart_flow_matches_jax(tmp_path):
    """Train 6, save, destroy, re-instantiate, restore, train 6: the loss
    continues where it left off, in both packages alike."""
    services = ["volumes", "data", "lm-trainer"]
    extra = {"global_batch": 4, "seq_len": 32}
    jv, tv = _pair(tmp_path, "granite-moe-1b-a400m", services, extra)
    losses = {}
    for name, vre in (("jax", jv), ("port", tv)):
        vre.instantiate()
        trainer = vre.service("lm-trainer")
        if name == "port":
            trainer.state = train_state_from_numpy(jax_state, "cpu")
        else:
            jax_state = jax.tree.map(np.asarray, trainer.state)
        first = trainer.train_steps(vre.service("data"), 6)
        vre.service("volumes").save(trainer.state, step=6, blocking=True)
        vre.destroy()
        vre2 = type(vre)(vre.config)
        vre2.instantiate()
        t2 = vre2.service("lm-trainer")
        t2.state = vre2.service("volumes").restore(t2.state, step=6)
        second = t2.train_steps(vre2.service("data"), 6)
        vre2.destroy()
        assert np.isfinite(second[-1])
        assert second[0] < first[0] + 1.0, "restore must continue"
        losses[name] = first + second
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=RTOL)


@pytest.mark.parametrize("microbatches", [2])
def test_microbatches_extra_matches_jax(tmp_path, microbatches):
    services = ["data", "lm-trainer"]
    extra = {"global_batch": 4, "seq_len": 16, "microbatches": microbatches}
    jv, tv = _pair(tmp_path, "gemma2-27b", services, extra)
    jv.instantiate()
    tv.instantiate()
    try:
        jt, tt = jv.service("lm-trainer"), tv.service("lm-trainer")
        tt.state = train_state_from_numpy(jax.tree.map(np.asarray, jt.state),
                                          "cpu")
        np.testing.assert_allclose(tt.train_steps(tv.service("data"), 3),
                                   jt.train_steps(jv.service("data"), 3),
                                   rtol=RTOL)
    finally:
        jv.destroy()
        tv.destroy()


def test_ssm_trainer_fails_at_apply_naming_a7b(tmp_path):
    cfg = VREConfig(name="t", services=["volumes", "lm-trainer"],
                    arch="mamba2-370m", provider="cpu", workdir=str(tmp_path))
    vre = VirtualResearchEnvironment(cfg)
    with pytest.raises(NotImplementedError, match=r"A\.7b"):
        vre.instantiate()
    assert vre.services == {}
