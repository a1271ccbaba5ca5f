"""The port's SPMD train step for the xLSTM kinds against the reference's
jitted sharded step, on 4 CPU ``gloo`` ranks and 4 forced host devices;
the checks (a) to (e) and their bounds are ``tests/_torch_spmd_kinds.py``'s
(the MoE configs: ``test_torch_spmd_kinds_moe.py`` and
``test_torch_spmd_kinds_mla.py``).

Cases: reduced xlstm-350m (``mlstm`` and ``slstm``: the mLSTM kernel's
wrapper through ``local_map``, the sLSTM loop through ``kops.shard_map``
with heads over the model axis) on the (2, 2), (4, 1) and (1, 4) meshes.
Worst measured, as a fraction of its tolerance (``worst_fraction``): the
grad norm, 0.21 (2x2), 0.18 (4x1), 0.16 (1x4); every leaf lower."""
import _torch_spmd
import _torch_spmd_kinds as kinds
from _torch_spmd_kinds import (  # noqa: F401 (the fixture and the checks)
    runs, test_cases_take_the_modes_they_name,
    test_constraint_placements_match_reference_spec,
    test_local_shards_match_reference_devices_indices_map,
    test_sharded_step_matches_reference, test_two_runs_are_bit_identical,
    test_world_of_one_equals_the_eager_step)

ARCHS = ("xlstm-350m",)
CASES = _torch_spmd.cases(ARCHS, {})


def pytest_generate_tests(metafunc):
    kinds.parametrize(metafunc, CASES, ARCHS)
