"""The pair tier, ``auto``'s route for levels up to 512 wide.

Set-up: ``plan_pairs`` on the host, then ``PairDiploidDP`` ships the plan
(``plan_to_device``). A solve is ``PairDiploidDP.run()``: the forward (K1
narrow runs, K2 / K3 wide runs), the traceback (K-T) and the host's read
of the result. The traced solve runs the same body in its parts.
"""

from dipgenie_tpu_torch import native
from dipgenie_tpu_torch.ops.diploid_pair import RUNS, PairDiploidDP, assemble
from dipgenie_tpu_torch.ops.narrow import narrow_run_global
from dipgenie_tpu_torch.ops.plan import plan_pairs
from dipgenie_tpu_torch.ops.trace import trace

# the wrappers whose ``launches`` count kernel launches
COUNTERS = (*RUNS.values(), narrow_run_global, trace)
# the program's body that ``traced_solve`` mirrors: the sha1 of its dedented
# source, first 16 digits (``tests/test_bench_layout.py`` fails when the
# body changes and the mirror has not been brought up to date)
MIRRORS = {"dipgenie_tpu_torch.ops.diploid_pair:PairDiploidDP.run":
           "24aa45a60595cac4"}


def build():
    """The native planner library (``dg_pair_tables``), built at first use
    in a checkout; ``plan_pairs`` falls back to numpy without it."""
    native.available()


def setup(csr, R, device, span):
    with span("pair.plan"):
        plan = plan_pairs(*csr, R)
    with span("pair.ship", sync=True):
        return PairDiploidDP(plan, device)


def solve(dp):
    return dp.run()


def traced_solve(dp, layer):
    """``PairDiploidDP.run()``, bracketed."""
    with layer("pair.forward", "forward"):
        V, bps = dp.forward()
    with layer("pair.trace", "trace"):
        recs = trace(dp.dplan, bps)
    with layer("pair.trace", "readback", host=True):
        return assemble(int(V[dp.R, 0]), recs.cpu().numpy())
