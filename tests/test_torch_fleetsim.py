"""The port's fleet simulator against the JAX package's. The simulator runs
on a virtual clock and does no device work, so it is held here, on the
CPU: a reduced fleet gives a report equal to the reference's field by
field, with the same link constants given to both ``HardwareModel``s
(never their defaults, which differ between a TPU and an H100 model)."""
import dataclasses
from dataclasses import replace

import pytest

from repro.core import HardwareModel as JaxHardwareModel
from repro.core import fleetsim as jax_fleetsim
from repro.core import placement as jax_placement
from repro_torch.core import HardwareModel, fleetsim, placement

LINKS = {"peer_bw": 12e9, "peer_rtt": 4e-4, "cloud_bw": 0.8e9, "cloud_rtt": 25e-3,
         "ingest_bw": 9e9, "disk_bw": 1.1e9, "dir_op_s": 3e-6, "dir_rtt": 2.5e-4,
         "dir_sync_entry_s": 6e-7}


def _hw_pair():
    """Both packages' models with every shared field equal: the reference's
    values, with the link constants above on top."""
    ref = JaxHardwareModel()
    shared = {f.name: getattr(ref, f.name) for f in dataclasses.fields(JaxHardwareModel)
              if f.init and f.name in {g.name for g in dataclasses.fields(HardwareModel)}}
    shared.update(LINKS)
    return JaxHardwareModel(**shared), HardwareModel(**shared)


SMALL = {"n_nodes": 20, "n_models": 20, "n_sharded": 2, "data_shards": 4,
         "n_requests": 600, "rate_rps": 50.0, "node_capacity": 4, "n_dir_shards": 8}
FAULTS = (("stale_flood", 1.0, 0.0, 40), ("partition", 1.5, 1.0, 100),
          ("kill_hot_owner", 2.5, 0.0, 100), ("churn", 3.2, 0.0, 100))


def _configs(directory, faults, **extra):
    def build(mod, pmod):
        cfg = {**SMALL, **extra, "directory": directory}
        if cfg.get("planner"):
            cfg["planner_cfg"] = pmod.PlannerConfig(bin_s=0.5, min_bursts=3,
                                                    min_arrivals=4, lead_s=0.5)
        fs = (mod.DEFAULT_FAULTS if faults == "default"
              else tuple(mod.Fault(*f) for f in FAULTS) if faults == "small" else ())
        return mod.FleetConfig(**cfg, faults=fs)
    return build(jax_fleetsim, jax_placement), build(fleetsim, placement)


CASES = {
    "sharded-default-faults": ("sharded", "default", {}),
    "single-default-faults": ("single", "default", {}),
    "sharded-small-faults": ("sharded", "small", {}),
    "sharded-no-faults": ("sharded", "none", {}),
    "diurnal-planner": ("sharded", "none", {"workload": "diurnal", "planner": True,
                                            "period_s": 1.5, "n_requests": 900}),
    "bursty-planner": ("sharded", "small", {"workload": "bursty", "period_s": 1.2,
                                           "planner": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_matches_reference(case):
    directory, faults, extra = CASES[case]
    jcfg, pcfg = _configs(directory, faults, **extra)
    jhw, phw = _hw_pair()
    want = jax_fleetsim.FleetSim(jcfg, hw=jhw).run()
    got = fleetsim.FleetSim(pcfg, hw=phw).run()
    assert list(got) == list(want)
    for field in want:
        assert got[field] == want[field], field
    assert got["opens"] == got["warm_hits"] + got["cold_opens"] > 0
    if faults == "default":
        assert got["drops"] == 2 and got["views_agree"]


def test_trace_matches_reference():
    jcfg, pcfg = _configs("sharded", "none")
    jhw, phw = _hw_pair()
    want = jax_fleetsim.FleetSim(jcfg, hw=jhw).trace()
    got = fleetsim.FleetSim(pcfg, hw=phw).trace()
    assert got == want and len(got) == SMALL["n_requests"]


def test_compare_policies_matches_reference():
    jcfg, pcfg = _configs("sharded", "none")
    want = jax_fleetsim.compare_policies(jcfg, hw=_hw_pair()[0])
    got = fleetsim.compare_policies(pcfg, hw=_hw_pair()[1])
    assert got == want
    assert got["sharded"]["dir_throughput_ops_s"] > got["single"]["dir_throughput_ops_s"]


def test_unknown_fault_kind_raises():
    cfg = replace(_configs("sharded", "none")[1], faults=(fleetsim.Fault("meteor", at_s=1.0),))
    with pytest.raises(ValueError):
        fleetsim.FleetSim(cfg, hw=_hw_pair()[1]).run()
