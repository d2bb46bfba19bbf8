"""Shared inputs and helpers of the port's serving, ingress, sigstore and
cell tests (`tests/test_torch_serving.py`, `test_torch_ingress.py`,
`test_torch_sigstore.py`, `test_torch_cell.py`).

- `mixed_items(n, seed)`: seeded items in the replay mix from the port's
  `utils/blockgen.mixed_items` (its builders byte-equal to the JAX
  package's, `tests/test_torch_batch.py`), with corrupted inputs;
- `reference(item)`: the JAX package's per-input API verdict
  (ok, Error, ScriptError) of an item, `norm(results)` a result list's;
- `PlainRows`: the port's `verify_tiles` on CPU tensors with each distinct
  lane row run once, so a rotated sentinel, a retry or a second dispatch of
  the same checks costs nothing; `checked(fn)` makes such a lane function
  the verifier's checked launch (the port's plain epilogue on its
  verdicts); `patch_plain_rows(monkeypatch)` installs it for a test's
  verifiers;
- `ref_host_verifier()`: the JAX package's verifier parked on its host
  rung, as its own cell tests make it, so its dispatches never compile.
"""

import functools

import torch

from bitcoinconsensus_tpu import api as JAPI
from bitcoinconsensus_tpu_torch.crypto import torch_backend as TB
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
from bitcoinconsensus_tpu_torch.utils import blockgen

torch.set_num_threads(1)


@functools.lru_cache(maxsize=4)
def mixed_items(n: int, seed: int, corrupt_rate: float = 0.1):
    items, bad = blockgen.mixed_items(n, seed=seed, corrupt_rate=corrupt_rate)
    return list(items), list(bad)


def reference(item):
    """(ok, Error, ScriptError) of the JAX package's per-input API."""
    try:
        if item.spent_outputs is not None:
            JAPI.verify_with_spent_outputs(item.spending_tx, item.input_index,
                                           item.spent_outputs, item.flags)
        else:
            JAPI.verify_with_flags(item.spent_output_script, item.amount,
                                   item.spending_tx, item.input_index, item.flags)
    except JAPI.ConsensusError as e:
        return False, int(e.code), None if e.script_error is None else int(e.script_error)
    return True, 0, 0


def norm(results):
    return [(r.ok, int(r.error),
             None if r.script_error is None else int(r.script_error)) for r in results]


class PlainRows:
    """`verify_tiles` on CPU tensors, each distinct lane row run once."""

    def __init__(self):
        self.memo = {}
        self.runs = 0

    def __call__(self, *args):
        arrs = [a.numpy() for a in args]
        keys = [b"".join(a[i].tobytes() for a in arrs) for i in range(len(arrs[0]))]
        todo = {}
        for i, k in enumerate(keys):
            if k not in self.memo and k not in todo:
                todo[k] = i
        if todo:
            idx = torch.tensor(list(todo.values()))
            ok, needs = VT.verify_tiles(*(a[idx].contiguous() for a in args))
            for j, k in enumerate(todo):
                self.memo[k] = (bool(ok[j]), bool(needs[j]))
            self.runs += 1
        got = [self.memo[k] for k in keys]
        return (torch.tensor([g[0] for g in got], dtype=torch.bool),
                torch.tensor([g[1] for g in got], dtype=torch.bool))


PLAIN = PlainRows()  # shared by every test of these files: one process memo


def checked(verify):
    """`verify_tiles_checked` on CPU tensors over the lane function
    `verify` ((ok, needs) of the packed 7-tuple): the port's plain epilogue
    (`epilogue_reference`) on its verdicts."""
    def run(*args, live=None, ok_out=None, needs_out=None, partials=True):
        return VT.epilogue_reference(*verify(*args), live, ok_out, needs_out, partials)
    return run


def patch_plain_rows(mp):
    mp.setattr(TB, "verify_tiles_checked", checked(PLAIN))
    return PLAIN


def ref_host_verifier():
    """The JAX package's verifier with its ladder parked on the host rung
    (`cell.replica._force_host`): host-exact verdicts, no compile."""
    from bitcoinconsensus_tpu.cell.replica import _force_host
    from bitcoinconsensus_tpu.crypto.jax_backend import TpuSecpVerifier

    verifier = TpuSecpVerifier(min_batch=8)
    _force_host(verifier)
    return verifier
