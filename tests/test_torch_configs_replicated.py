"""The shipped configs that no served test of the port covered before,
served on the CPU through both packages (part 2: the replicated
topologies; ``tests/test_torch_configs.py`` has the
single-instance ones).

Each config is served as a narrowed one-card copy
(``tests/torch_config_copies.py``: its topology as shipped, every device
index made 0, only its geometry narrowed) through the port and the JAX
package on the JAX package's seeded weights. Each copy: keeps the
shipped topology and every other key; serves every request with logits
(or a class id) held to the JAX stages' at the bf16 bound stated in
``torch_config_copies.assert_logits_close``; writes a job directory
that both packages' ``check_job`` pass; builds the reference's
instances step by step.
"""

import pytest
import torch

import torch_config_copies as copies
from torch_config_copies import jax_stages, served  # noqa: F401

torch.set_num_threads(2)

NAMES = copies.CONFIGS[5:]


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

