"""The control, put in the program's place: the plain reference with one
guarantee the configurations state broken, the tie rule (among candidates
of equal value the latest wins, not the earliest). ``control.py`` runs it;
no cell of ``BENCHMARK.json`` does. A run of it must come out not correct.

Its answer is worked out once in set-up (the forward on the device, the
walk from the sink on the host); a solve hands it back.
"""

import reference

COUNTERS = ()


def setup(csr, R, device, span):
    with span("control.solve", sync=True):
        return reference.solve(reference.forward(csr, R, device,
                                                 latest=True))


def solve(answer):
    return answer


def traced_solve(answer, layer):
    return answer
