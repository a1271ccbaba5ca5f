"""The port's SPMD train step for the MLA kinds and the MTP module against
the reference's jitted sharded step, on 4 CPU ``gloo`` ranks and 4 forced
host devices; the checks (a) to (e) and their bounds are
``tests/_torch_spmd_kinds.py``'s.

Cases: reduced deepseek-v3-671b (``mla_dense``, ``mla_moe`` and the MTP
module, whose layer is ``mla_moe`` too and whose projection the reference
constrains over the batch; Adafactor, bf16 accumulation and momentum; 4
experts at top-2 fill every mesh, so its MoE takes the expert-parallel path
in GRID mode) on the (2, 2), (4, 1) and (1, 4) meshes (on (4, 1) the
microbatch of 2 rows does not split over the 4 data rows: each row
dispatches the same tokens); the dense dispatch under a rule set:
``test_torch_spmd_kinds_dense.py``. Worst measured, as a fraction of its
tolerance (``worst_fraction``): a bf16 Adafactor momentum leaf in every
case: one bf16 step off on (2, 2) and (1, 4) (1.0 of its floor), 0.5 on
(4, 1)."""
import _torch_spmd
import _torch_spmd_kinds as kinds
from _torch_spmd_kinds import (  # noqa: F401 (the fixture and the checks)
    runs, test_cases_take_the_modes_they_name,
    test_constraint_placements_match_reference_spec,
    test_local_shards_match_reference_devices_indices_map,
    test_sharded_step_matches_reference, test_two_runs_are_bit_identical,
    test_world_of_one_equals_the_eager_step)

ARCHS = ("deepseek-v3-671b",)
CASES = _torch_spmd.cases(ARCHS, {})


def pytest_generate_tests(metafunc):
    kinds.parametrize(metafunc, CASES, ARCHS)
