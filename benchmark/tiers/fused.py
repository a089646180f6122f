"""The fused tier, ``auto``'s route past 512 wide (``--dp-backend fused``).

Set-up: ``plan_fused`` on the host. A solve is ``FusedDiploidDP.run()``:
the ship of the tables, the forward (K13: the run kernel on runs of
narrow transitions, the per-transition kernel on the others), the sink's
read, the traceback (K14) and ``path_transitions`` on the host. The
traced solve runs the same body in its parts.
"""

from dipgenie_tpu_torch.ops import fused

# the wrappers whose ``launches`` count kernel launches
COUNTERS = (fused.fused_forward, fused.fused_trace)
# the program's body that ``traced_solve`` mirrors (as in ``tiers/pair.py``)
MIRRORS = {"dipgenie_tpu_torch.ops.fused:FusedDiploidDP.run":
           "14068f46c2245f05"}


def setup(csr, R, device, span):
    with span("fused.plan"):
        plan = fused.plan_fused(*csr, R)
    return fused.FusedDiploidDP(plan, device)


def solve(dp):
    return dp.run()


def traced_solve(dp, layer):
    """``FusedDiploidDP.run()``, bracketed."""
    if dp.plan.T == 0:
        return 0, 0, []
    with layer(None, "ship"):
        dev = dp.ship()
    with layer("fused.forward", "forward"):
        V, bp = dp.forward(dev)
    with layer("fused.trace", "readback", host=True):
        value = int(V[dp.R, 0, 0])
    with layer("fused.trace", "trace"):
        rows, sh = fused.fused_trace(dev, bp, dp.R)
    with layer("fused.trace", "readback", host=True):
        return value, sh, fused.path_transitions(rows.cpu().numpy())
