"""A donating train step (``make_train_step(..., donate=True)``) against the
plain one on the CPU.

The reference jits its train step with ``donate_argnums=(0, 1)``, so XLA
may reuse the buffers of the parameters and optimizer state it is given.
The port's donating step writes the new moments over the old ones
(``update(..., inplace=True)``) and each new parameter over the old one.
It must compute the same numbers as the step that builds new tensors:
here, three steps of reduced f32 deepseek-v3 (MLA and the MTP group) and
of reduced olmo-1b from the same parameters and state copies, under
AdamW, give the same losses, grad norms, parameters and moments bit for
bit, and the donating step returns the tensors it was given.  An
optimizer whose update cannot write in place (Adafactor) is refused."""

import numpy as np
import pytest
import torch

from repro_torch import flags
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import adafactor, adamw
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    yield
    flags.reset()


def _batch(vocab, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, vocab, (b, s + 1)))
    return {"tokens": toks[:, :-1].contiguous(),
            "targets": toks[:, 1:].contiguous()}


def _state_leaves(state):
    return [x for part in state[1:] for x in tree_leaves(part)]


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "olmo-1b"])
def test_a_donating_step_computes_what_the_plain_step_does(arch):
    cfg = reduce_config(get_config(arch), dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    plain_step, opt = make_train_step(cfg, optimizer=adamw(1e-3))
    donate_step, _ = make_train_step(cfg, optimizer=adamw(1e-3),
                                     donate=True)
    p_plain, s_plain = params, opt.init(params)
    p_don = tree_map(torch.clone, params)
    s_don = opt.init(p_don)
    for i in range(3):
        batch = _batch(cfg.vocab_size, seed=i)
        p_plain, s_plain, m_plain = plain_step(p_plain, s_plain, batch)
        given = [x.data_ptr() for x in tree_leaves(p_don)]
        given_state = [x.data_ptr() for x in _state_leaves(s_don)]
        p_don, s_don, m_don = donate_step(p_don, s_don, batch)
        assert [x.data_ptr() for x in tree_leaves(p_don)] == given
        assert [x.data_ptr() for x in _state_leaves(s_don)] == given_state
        for k in ("loss", "grad_norm"):
            assert torch.equal(m_plain[k], m_don[k]), (i, k)
        assert int(s_plain.step) == int(s_don.step) == i + 1
    for a, b in zip(tree_leaves(p_plain), tree_leaves(p_don)):
        assert torch.equal(a, b)
    for a, b in zip(_state_leaves(s_plain), _state_leaves(s_don)):
        assert torch.equal(a, b)
    # the plain step left its inputs as they were: the first parameters
    # are still the initial ones
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(init_params(cfg, seed=0,
                                                     device="cpu"))))


def test_a_donating_step_refuses_an_optimizer_that_cannot_write_in_place():
    cfg = reduce_config(get_config("olmo-1b"), dtype="float32")
    assert adamw(1e-3).inplace and not adafactor(1e-3).inplace
    with pytest.raises(ValueError, match="donate"):
        make_train_step(cfg, optimizer=adafactor(1e-3), donate=True)
    # the plain step takes it
    make_train_step(cfg, optimizer=adafactor(1e-3))
