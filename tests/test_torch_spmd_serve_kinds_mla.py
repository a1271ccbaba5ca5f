"""The port's sharded serving for the MLA kinds against the reference's
jitted sharded prefill and decode, on 4 CPU ``gloo`` ranks and 4 forced
host devices; the checks (a) to (e) and their bounds are
``tests/_torch_spmd_serve_kinds.py``'s.

Cases: reduced deepseek-v3-671b (``mla_dense`` and ``mla_moe``: the latent
cache written through ``write_slice``, the absorbed decode over the cache
that ``cache_axes`` splits over the sequence, each rank's rows and heads
through ``kops.shard_map``; its MoE takes the expert-parallel path in GRID
mode on every mesh) on the (2, 2), (4, 1) and (1, 4) meshes. Besides, the
reference alone: its sharded prefill departs from its plain one where
routing is uneven across the data rows, and the cause is the
expert-parallel path's capacity (``test_reference_sharded_moe_capacity_
departs``). Worst measured, as a fraction of its tolerance
(``worst_fraction``): 0.33 (2x2, the MoE layer's rope key), 0.62 (4x1,
its latent), 0.52 (1x4, the prefill's logits)."""
import _torch_spmd_serve as harness
import _torch_spmd_serve_kinds as kinds
from _torch_spmd_serve_kinds import (  # noqa: F401 (fixture and checks)
    runs, test_cache_blocks_match_reference_devices_indices_map,
    test_greedy_tokens_match_where_the_gap_is_clear,
    test_reference_sharded_moe_capacity_departs,
    test_sharded_serve_matches_reference, test_two_runs_are_bit_identical,
    test_world_of_one_equals_the_eager_serve)

ARCHS = ("deepseek-v3-671b",)
CASES = harness.cases(ARCHS, {})


def pytest_generate_tests(metafunc):
    kinds.parametrize(metafunc, CASES, ARCHS)
