"""The driver entry points must work in every environment.

dryrun_multichip self-hosts a virtual n-device CPU mesh when fewer devices
exist, so the sharded training step is always exercisable, and reports the
platform it ran on. Under pytest the conftest already provides 8 virtual
CPU devices, so the inline path runs here.
"""

import jax

import __graft_entry__ as entry


def test_entry_compiles():
    fn, args = entry.entry()
    out = jax.eval_shape(fn, *args)
    assert out.shape[-1] == 4


def test_dryrun_multichip_inline():
    assert len(jax.devices()) >= 8  # conftest virtual mesh
    assert entry.dryrun_multichip(8) == "cpu"
