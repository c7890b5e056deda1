"""Where :class:`Collectives` puts the buffers it hands the backend.

Without ``stage`` (NCCL, a card a rank; gloo on the host) every buffer a
collective sends from or receives into lies on its input's device; NCCL
takes no host buffer.  A stand-in for ``torch.distributed`` records the
devices of the buffers each call is given, for an input on the meta device
(a device other than the host's, as a card's tensors are) and on the host.
"""
import pytest
import torch

from repro_torch.runtime import collectives as coll


class _Done:
    def wait(self):
        return True


@pytest.fixture
def seen(monkeypatch):
    """The devices of the buffers each stand-in call was given."""
    out = []

    def record(*tensors):
        out.extend(t.device for t in tensors)

    monkeypatch.setattr(coll.dist, "all_gather",
                        lambda parts, x, group=None: record(*parts, x))
    monkeypatch.setattr(coll.dist, "all_to_all_single",
                        lambda recv, send, group=None: record(recv, send))
    monkeypatch.setattr(coll.dist, "irecv",
                        lambda buf, src=None, group=None: (record(buf), _Done())[1])
    monkeypatch.setattr(coll.dist, "isend",
                        lambda buf, dst=None, group=None: (record(buf), _Done())[1])
    monkeypatch.setattr(coll.dist, "get_global_rank", lambda group, r: r)
    return out


CALLS = {
    "all_gather": lambda c, x: c.all_gather(x, dim=1),
    "all_to_all": lambda c, x: c.all_to_all(x, split_dim=0, concat_dim=1),
    "permute_recv": lambda c, x: c.permute(x, "model", [(1, 0)]),
    "permute_send": lambda c, x: c.permute(x, "model", [(0, 1)]),
}


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(CALLS))
def test_unstaged_buffers_lie_on_the_input_device(seen, kind, dtype, device):
    comm = coll.Collectives({"model": 2}, {"model": None}, route="dist", stage=False,
                            index={"model": 0})
    x = torch.zeros(4, 6, dtype=dtype, device=device)
    out = CALLS[kind](comm, x)
    assert seen and all(d == x.device for d in seen), seen
    if out is not None:
        assert out.device == x.device and out.dtype == dtype
