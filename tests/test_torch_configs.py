"""The shipped configs that no served test of the port covered before,
served on the CPU through both packages (part 1: the single-instance
topologies; ``tests/test_torch_configs_replicated.py`` has the
replicated ones).

Each config is served as a narrowed one-card copy
(``tests/torch_config_copies.py``: its topology as shipped, every device
index made 0, only its geometry narrowed) through the port and the JAX
package on the JAX package's seeded weights. Each copy: keeps the
shipped topology and every other key; serves every request with logits
(or a class id) held to the JAX stages' at the bf16 bound stated in
``torch_config_copies.assert_logits_close``; writes a job directory
that both packages' ``check_job`` pass; builds the reference's
instances step by step. Also here: every shipped config is served by a
run of ``chip_smoke.py``, as shipped or as a one-card copy.
"""

import json
import os

import pytest
import torch

import chip_smoke
import torch_config_copies as copies
from torch_config_copies import jax_stages, served  # noqa: F401

torch.set_num_threads(2)

NAMES = copies.CONFIGS[:5]


@pytest.mark.parametrize("name", NAMES)
def test_the_narrowed_copy_keeps_the_shipped_topology(name, tmp_path):
    copies.check_topology(name, tmp_path)


@pytest.mark.parametrize("name", NAMES)
def test_the_copy_serves_the_jax_stages_logits(name, served, jax_stages):
    copies.check_logits(served(name), jax_stages)


@pytest.mark.parametrize("name", NAMES)
def test_both_check_jobs_pass_on_the_copy_s_job(name, served):
    copies.check_jobs(served(name))


@pytest.mark.parametrize("name", NAMES)
def test_the_port_builds_the_reference_s_instances(name, served):
    copies.check_instances(served(name))


def test_every_shipped_config_is_served_by_a_chip_smoke_run():
    # read from the smoke's run lists, no run started
    shipped = sorted("configs/" + n for n in os.listdir(
        os.path.join(copies.REPO, "configs")) if n.endswith(".json"))
    assert len(shipped) == 41
    assert sorted(chip_smoke.SERVED_CONFIGS) == shipped
    assert len(set(chip_smoke.SERVED_CONFIGS)) == len(
        chip_smoke.SERVED_CONFIGS)
    # this file's configs, in the smoke's one phase for them, in order
    assert [config for _, config in chip_smoke.CONFIG_RUNS] == [
        "configs/%s.json" % name for name in copies.CONFIGS]
    for label, config in chip_smoke.CONFIG_RUNS:
        with open(os.path.join(copies.REPO, config)) as f:
            devices = [d for step in json.load(f)["pipeline"]
                       for g in step["queue_groups"] for d in g["devices"]]
        # served as shipped (labelled by its path) exactly where the
        # shipped config names no card but 0
        assert (label == config) == all(d <= 0 for d in devices), config
