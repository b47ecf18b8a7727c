"""`chip_smoke.py`'s kernels-against-plain gradient check on the CPU:
`same_relu_branches` makes the plain pass differentiate the branch of each
ReLU / LeakyReLU that the kernel pass took, changes nothing where the two
passes agree on every sign, and fails where more than a sliver of a layer's
inputs change sign or any change lies far from 0."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import KINK_FLIPS_MAX, same_relu_branches  # noqa: E402

torch.set_num_threads(1)


class _Block(torch.nn.Module):
    """A Linear named like the fusion layers' FFN input, then ReLU."""

    def __init__(self, n_in=4, n_out=4096):
        super().__init__()
        self.ffn1 = torch.nn.Linear(n_in, n_out)

    def forward(self, x):
        return torch.relu(self.ffn1(x)).sum()


def _grads(model, x):
    model.zero_grad()
    model(x).backward()
    return model.ffn1.weight.grad.clone(), model.ffn1.bias.grad.clone()


def test_same_signs_change_nothing():
    model = _Block()
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    recorded, flips = {}, {}
    with same_relu_branches(model, recorded, flips, align=False):
        want = _grads(model, x)
    with same_relu_branches(model, recorded, flips, align=True):
        got = _grads(model, x)
    assert flips == {} and all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(recorded["ffn1"]) == 1


def test_a_sign_change_near_zero_takes_the_first_pass_branch():
    """One output of the first pass at +1e-6 that the second pass puts at
    -1e-6: without alignment its unit's bias gradient differs by a whole
    term; aligned, the second pass gives the first pass's gradients."""
    model = _Block(n_out=20000)
    x = torch.ones(1, 4)
    with torch.no_grad():
        model.ffn1.bias[7] = 1e-6 - model.ffn1.weight[7].sum()
    recorded, flips = {}, {}
    with same_relu_branches(model, recorded, flips, align=False):
        want = _grads(model, x)
    with torch.no_grad():
        model.ffn1.bias[7] -= 2e-6
    assert not torch.equal(_grads(model, x)[1], want[1])
    with same_relu_branches(model, recorded, flips, align=True):
        got = _grads(model, x)
    assert set(flips) == {"ffn1[0]"} and flips["ffn1[0]"][0] == 1
    torch.testing.assert_close(got[1], want[1])
    torch.testing.assert_close(got[0], want[0])


@pytest.mark.parametrize("case", ["many", "far"])
def test_sign_changes_beyond_the_limits_fail(case):
    """More than KINK_FLIPS_MAX of a layer's outputs changing sign, or a
    single one (1 in 20,000) moving further than KINK_GAP_MAX, fails the
    check instead of being aligned."""
    model = _Block(n_out=20000)
    x = torch.ones(1, 4)
    recorded, flips = {}, {}
    with same_relu_branches(model, recorded, flips, align=False):
        _grads(model, x)
    first = recorded["ffn1"][0][0]
    with torch.no_grad():
        if case == "many":
            model.ffn1.bias -= 2 * first         # every output changes sign
        else:
            model.ffn1.bias[0] += -torch.sign(first[0]) * (first[0].abs() + 1.0) - first[0]
    assert 1 / 20000 < KINK_FLIPS_MAX
    with pytest.raises(AssertionError, match="change sign"):
        with same_relu_branches(model, recorded, flips, align=True):
            _grads(model, x)
