"""The port's SPMD train step with the MoE's dense dispatch under a rule
set against the reference's jitted sharded step, on 4 CPU ``gloo`` ranks
and 4 forced host devices; the checks (a) to (c) and (e) and their bounds
are ``tests/_torch_spmd_kinds.py``'s (the world of one of this config:
``test_torch_spmd_kinds_mla.py``).

Case: reduced deepseek-v3-671b (with MTP) with 8 experts on the (2, 2)
mesh: no mode fits, and the dense dispatch runs on DTensors, its sort and
gather over every token on each rank, its expert products on ``xe``
placed by moe's two ``("experts", None, None)`` sites (recorded in (c)).
Worst measured, as a fraction of its tolerance (``worst_fraction``): 0.5,
a bf16 Adafactor momentum leaf."""
import _torch_spmd_kinds as kinds
from _torch_spmd_kinds import (  # noqa: F401 (the fixture and the checks)
    runs, test_cases_take_the_modes_they_name,
    test_constraint_placements_match_reference_spec,
    test_local_shards_match_reference_devices_indices_map,
    test_sharded_step_matches_reference, test_two_runs_are_bit_identical)

ARCHS = ()
CASES = [("deepseek-v3-671b@2x2/dense", "deepseek-v3-671b", {"num_experts": 8},
          (2, 2))]


def pytest_generate_tests(metafunc):
    kinds.parametrize(metafunc, CASES, ARCHS)
