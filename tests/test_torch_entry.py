"""The port's entry points (``poasta_tpu_torch/entry.py``), the
counterparts of ``__graft_entry__.py``: ``entry()`` on host tensors, and
``dryrun_multichip`` over eight CPU entries."""

import numpy as np
import pytest
import torch

from poasta_tpu_torch.entry import dryrun_multichip, entry
from poasta_tpu_torch.utils.device import NoDeviceError

torch.set_num_threads(1)


def test_entry_scores_equal_the_reference_entry():
    """``entry(device="cpu")``'s step gives the reference entry's scores
    on the same toy graph and reads."""
    from __graft_entry__ import entry as jax_entry

    fn, args = entry(device="cpu")
    jfn, jargs = jax_entry()
    want = np.asarray(jfn(*jargs)).tolist()
    assert fn(*args).tolist() == want
    dg, qshift, lengths = args
    assert np.array_equal(qshift.numpy(), jargs[5])
    assert np.array_equal(lengths.numpy(), jargs[6])


def test_entry_builds_host_tensors_without_a_device_call(monkeypatch):
    """The default (the card) builds host tensors and touches no device;
    the step moves them to the card at the call, which raises without
    one."""
    def no_device_call():
        raise AssertionError("a device call")

    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", no_device_call)
        mp.setattr(torch.cuda, "device_count", no_device_call)
        fn, args = entry()
    dg, qshift, lengths = args
    assert dg.on_host and dg.device.type == "cpu"
    assert qshift.device.type == lengths.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError, match="no CUDA device"):
            fn(*args)


def test_dryrun_multichip_eight_entries(capsys):
    """A 4 x 2 mesh of eight entries (CPU entries without a card, the cards
    repeated with one): sharded scores, the meshed banded scorer and the
    meshed CLI equal one device's (the dry run raises otherwise)."""
    dryrun_multichip(8)
    out = capsys.readouterr().out
    if not torch.cuda.is_available():
        assert "8 CPU entries" in out
    assert "dp=4 sp=2" in out
