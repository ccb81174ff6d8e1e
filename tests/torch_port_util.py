"""Helpers shared by the ``test_torch_*`` parity tests: hand the JAX
package's params over to the port as numpy, and cap torch's threads."""

import numpy as np
import pytest
import torch

from llm_compressor_tpu.qformats.qtensor import QTensor as JQTensor


def jax_qspec(q) -> str:
    """DSL string of a JAX Quantizer (int formats)."""
    zp = "zp-" if q.zero_point else ""
    return f"{q.fmt.value}-g[{q.group_size}]-{zp}{'rw' if q.axes == -1 else 'cw'}"


def jax_to_numpy(tree):
    """JAX params tree -> nested dicts / lists of numpy arrays, with each
    QTensor as its field dict (the input format of ``convert.py``)."""
    if isinstance(tree, JQTensor):
        return {
            "codes": np.asarray(tree.codes), "scales": np.asarray(tree.scales),
            "zeros": None if tree.zeros is None else np.asarray(tree.zeros),
            "shape": tuple(tree.shape), "blocked_shape": tuple(tree.blocked_shape),
            "group_axis": tree.group_axis, "ngroups_axis": tree.ngroups_axis,
            "pair_planes": bool(tree.pair_planes), "dtype": np.dtype(tree.dtype).name,
            "qspec": jax_qspec(tree.quantizer),
        }
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several xdist workers: keep torch to one intra-op
    thread each instead of oversubscribing the cores. Module scope, so it
    also covers the module-scoped fixtures that run a whole slice."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
