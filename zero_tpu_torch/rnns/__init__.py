"""RNN cell zoo and time loops of the RNN models.

Counterpart of ``zero_tpu/rnns/__init__.py``: GRU, LSTM with the
concatenated [h, c] state and gates i, f, o, SRU, ATR, LRN and oLRN as
(init, fetch, step) triples; the masked ``rnn`` whose pad positions carry
the state through (h = m * h + (1 - m) * h_); the conditional ``cond_rnn``
(lower cell -> additive attention over a memory -> higher cell, or
``one2one``, the CAEncoder, which feeds memory position t to step t) and
its single decode step ``cond_rnn_step``.

``fetch`` projects a whole sequence's inputs once, so each time step runs
only the hidden-state products. The JAX package's ``lax.scan`` becomes a
Python loop over time: each step's state is collected in a list and
stacked once at the end (autograd keeps no buffer written in place), and
the fetched inputs are split into per-step views with one ``unbind``
(whose backward is one stack, not a full-size zero tensor a step). These
cells' gate math is not that of ``torch.nn.GRU``/``LSTM`` (this GRU
applies r to h_ before its hidden product; this LSTM carries [h, c]), so
cuDNN's RNNs are not used, and sequences are not packed: a pad step
carries the state.

Parameter modules are ``Tree``s whose state-dict names are the JAX param
paths (``forward.hide_x.ws.0``, ``backward.lower.gate_h.b``,
``decoder.attention.feed_query.ws.0``; SRU's ``v_f``/``v_r`` are bare
tensors).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from zero_tpu_torch.ops import attention as attn_mod
from zero_tpu_torch.ops import initializers as inits
from zero_tpu_torch.ops import nn


class Tree(torch.nn.Module):
    """Parameters named like a JAX param dict: tensors become parameters,
    modules sub-modules and lists of modules ModuleLists. Read entries as
    ``p["name"]``: "forward" (the encoder's forward RNN) is a method name
    of torch modules, so attribute access cannot reach it, and for the
    same reason the entries are placed without ``add_module``'s check."""

    def __init__(self, parts: dict):
        super().__init__()
        for name, value in parts.items():
            if isinstance(value, torch.Tensor):
                self._parameters[name] = torch.nn.Parameter(value)
            elif isinstance(value, (list, tuple)):
                self._modules[name] = torch.nn.ModuleList(value)
            else:
                self._modules[name] = value

    def __getitem__(self, name):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]


class CellDef(NamedTuple):
    name: str
    state_mult: int    # state width multiplier (lstm/sru carry [h, c])
    init: Callable     # (gen, d_in, d, ln, weight_init) -> Tree
    fetch: Callable    # (params, x, ln) -> tuple of projected inputs
    step: Callable     # (params, h_prev, xs, ln) -> h_new
    get_hidden: Callable  # (h) -> hidden output


def _lin(gen, d_in, d_out, bias, ln, weight_init):
    return nn.init_linear(gen, d_in, d_out, bias=bias, weight_init=weight_init,
                          ln=ln)


def _first_half(h):
    return h.chunk(2, dim=-1)[0]


def _same(h):
    return h


# -- GRU ---------------------------------------------------------------------

def _gru_init(gen, d_in, d, ln, wi):
    return Tree({"gate_x": _lin(gen, d_in, 2 * d, False, ln, wi),
                 "hide_x": _lin(gen, d_in, d, False, ln, wi),
                 "gate_h": _lin(gen, d, 2 * d, True, ln, wi),
                 "hide_h": _lin(gen, d, d, True, ln, wi)})


def _gate_fetch(p, x, ln):
    return (nn.linear(p["gate_x"], x, ln=ln), nn.linear(p["hide_x"], x, ln=ln))


def _gru_step(p, h_, xs, ln):
    x_g, x_h = xs
    h_g = nn.linear(p["gate_h"], h_, ln=ln)
    z, r = torch.sigmoid(x_g + h_g).chunk(2, dim=-1)
    h_h = nn.linear(p["hide_h"], h_ * r, ln=ln)
    h = torch.tanh(x_h + h_h)
    return z * h_ + (1.0 - z) * h


# -- LSTM --------------------------------------------------------------------

def _lstm_init(gen, d_in, d, ln, wi):
    return Tree({"gate_x": _lin(gen, d_in, 3 * d, False, ln, wi),
                 "hide_x": _lin(gen, d_in, d, False, ln, wi),
                 "gate_h": _lin(gen, d, 3 * d, True, ln, wi),
                 "hide_h": _lin(gen, d, d, True, ln, wi)})


def _lstm_step(p, h_full, xs, ln):
    x_g, x_c = xs
    h_, c_ = h_full.chunk(2, dim=-1)
    h_g = nn.linear(p["gate_h"], h_, ln=ln)
    i, f, o = torch.sigmoid(x_g + h_g).chunk(3, dim=-1)
    h_c = torch.tanh(x_c + nn.linear(p["hide_h"], h_, ln=ln))
    c = i * h_c + f * c_
    h = o * torch.tanh(c)
    return torch.cat([h, c], dim=-1)


# -- SRU ---------------------------------------------------------------------

def _sru_init(gen, d_in, d, ln, wi):
    return Tree({"hide_x": _lin(gen, d_in, 4 * d, False, ln, wi),
                 "v_f": wi(gen, (1, d)),
                 "v_r": wi(gen, (1, d))})


def _hide_fetch(p, x, ln):
    return (nn.linear(p["hide_x"], x, ln=ln),)


def _sru_step(p, h_full, xs, ln):
    x = xs[0]
    x_r, x_f, x_c, x_h = x.chunk(4, dim=-1)
    h_, c_ = h_full.chunk(2, dim=-1)
    v_f = p["v_f"].to(x.dtype)
    v_r = p["v_r"].to(x.dtype)
    f = torch.sigmoid(x_f + v_f * c_)
    c = f * c_ + (1.0 - f) * x_c
    r = torch.sigmoid(x_r + v_r * c_)
    h = r * c + (1.0 - r) * x_h
    return torch.cat([h, c], dim=-1)


# -- ATR ---------------------------------------------------------------------

def _atr_init(gen, d_in, d, ln, wi):
    return Tree({"hide_x": _lin(gen, d_in, d, False, ln, wi),
                 "hide_h": _lin(gen, d, d, True, ln, wi)})


def _atr_step(p, h_, xs, ln):
    p_in = xs[0]
    q = nn.linear(p["hide_h"], h_, ln=ln)
    f = torch.sigmoid(p_in - q)
    i = torch.sigmoid(p_in + q)
    return i * p_in + f * h_


# -- LRN / oLRN --------------------------------------------------------------

def _lrn_init(gen, d_in, d, ln, wi):
    return Tree({"hide_x": _lin(gen, d_in, 3 * d, False, ln, wi)})


def _lrn_step(p, h_, xs, ln):
    pp, q, r = xs[0].chunk(3, dim=-1)
    i = torch.sigmoid(pp + h_)
    f = torch.sigmoid(q - h_)
    return i * r + f * h_


def _olrn_init(gen, d_in, d, ln, wi):
    return Tree({"hide_x": _lin(gen, d_in, 4 * d, False, ln, wi)})


def _olrn_step(p, h_, xs, ln):
    pp, q, r, s = xs[0].chunk(4, dim=-1)
    i = torch.sigmoid(pp + h_)
    f = torch.sigmoid(q - h_)
    h = i * r + f * h_
    o = torch.sigmoid(s - h)
    return o * h


_CELLS = {
    "gru": CellDef("gru", 1, _gru_init, _gate_fetch, _gru_step, _same),
    "lstm": CellDef("lstm", 2, _lstm_init, _gate_fetch, _lstm_step,
                    _first_half),
    "sru": CellDef("sru", 2, _sru_init, _hide_fetch, _sru_step, _first_half),
    "atr": CellDef("atr", 1, _atr_init, _hide_fetch, _atr_step, _same),
    "lrn": CellDef("lrn", 1, _lrn_init, _hide_fetch, _lrn_step, _same),
    "olrn": CellDef("olrn", 1, _olrn_init, _hide_fetch, _olrn_step, _same),
}


def get_cell(name: str) -> CellDef:
    name = name.lower()
    if name not in _CELLS:
        raise NotImplementedError("%s is not supported" % name)
    return _CELLS[name]


def init_state_params(gen, cell: CellDef, d_in: int, d: int, ln,
                      weight_init) -> nn.Linear:
    """The projection that derives an initial state from an evidence
    vector."""
    return nn.init_linear(gen, d_in, d * cell.state_mult, bias=True,
                          weight_init=weight_init, ln=ln)


def init_state_from(params, cell: CellDef, x, ln=False):
    return nn.linear(params, x, ln=ln)


def zero_state(cell: CellDef, batch: int, d: int, dtype=torch.float32,
               device=None):
    return torch.zeros((batch, d * cell.state_mult), dtype=dtype,
                       device=device)


def step_views(tensors):
    """[B, L, ...] tensors -> per-step tuples of [B, ...] views."""
    return list(zip(*(v.unbind(1) for v in tensors)))


def step_masks(mask, length, batch, x):
    """Per-step keep columns m [B, 1] in x's dtype."""
    if mask is None:
        mask = torch.ones((batch, length), dtype=x.dtype, device=x.device)
    return mask.to(x.dtype)[..., None].unbind(1)


def carry(h_, h, m):
    """m * h + (1 - m) * h_ in one kernel: torch.lerp(h_, h, m) takes h_
    exactly at m = 0 and h exactly at m = 1 (it computes h - (h - h_) *
    (1 - m) from m = 0.5 up), the JAX package's values for a 0/1 mask."""
    return torch.lerp(h_, h, m)


# ---------------------------------------------------------------------------
# time loops
# ---------------------------------------------------------------------------

def rnn(cell: CellDef, params, x, d: int, mask=None, ln=False,
        init_state=None):
    """Masked unidirectional RNN over [B, L, d_in]; pad positions carry
    the previous state through. Returns ((outputs, last_state),
    (hidden_outputs, hidden_last))."""
    batch, length = x.shape[0], x.shape[1]
    h = (zero_state(cell, batch, d, x.dtype, x.device) if init_state is None
         else init_state)
    keep = step_masks(mask, length, batch, x)
    outs = []
    for t, vs in enumerate(step_views(cell.fetch(params, x, ln))):
        h = carry(h, cell.step(params, h, vs, ln), keep[t])
        outs.append(h)
    outputs = torch.stack(outs, dim=1)
    return ((outputs, h), (cell.get_hidden(outputs), cell.get_hidden(h)))


def init_cond_rnn(gen, cell_name: str, d_in: int, d_mem: int, d: int,
                  ln=False, weight_init=None, one2one=False,
                  att_num_heads: int = 1) -> Tree:
    """cond_rnn's parameters: the lower cell (input side), the higher cell
    (context side) and, unless one2one, the memory projection
    ``context_att`` and the attention, whose query is the lower cell's
    hidden output."""
    weight_init = weight_init or inits.variance_scaling(1.0, "uniform")
    cell = get_cell(cell_name)
    parts = {"lower": cell.init(gen, d_in, d, ln, weight_init),
             "higher": cell.init(gen, d_mem, d, ln, weight_init)}
    if not one2one:
        parts["context_att"] = nn.init_linear(
            gen, d_mem, d_mem, bias=False, weight_init=weight_init, ln=ln)
        parts["attention"] = attn_mod.init_additive_attention(
            gen, d, d_mem, d_mem, num_heads=att_num_heads,
            weight_init=weight_init)
    return Tree(parts)


def cond_rnn(cell_name: str, params, x, memory, d: int, init_state=None,
             mask=None, mem_mask=None, ln=False, one2one=False,
             num_heads: int = 1):
    """Conditional RNN: each step the lower cell, then additive attention
    over ``memory`` (one2one: memory position t itself), then the higher
    cell; pads carry the state through both cells.

    Returns ((outputs, last_state), (hidden_outputs, hidden_last),
    contexts [B, L, dm], attention weights [B, H, L, S])."""
    cell = get_cell(cell_name)
    batch, length = x.shape[0], x.shape[1]
    src_len = memory.shape[1]
    h = (zero_state(cell, batch, d, x.dtype, x.device) if init_state is None
         else init_state)
    if mem_mask is None:
        mem_mask = torch.ones((batch, src_len), dtype=x.dtype,
                              device=x.device)
    keep = step_masks(mask, length, batch, x)
    lower_xs = step_views(cell.fetch(params["lower"], x, ln))
    if one2one:
        higher_xs = step_views(cell.fetch(params["higher"], memory, ln))
    else:
        proj_memories = nn.linear(params["context_att"], memory, ln=ln)

    outs, contexts, weights = [], [], []
    for t in range(length):
        s = carry(h, cell.step(params["lower"], h, lower_xs[t], ln), keep[t])
        if one2one:
            c_c = higher_xs[t]
        else:
            vle = attn_mod.additive_attention(
                params["attention"], cell.get_hidden(s), memory, mem_mask,
                num_heads=num_heads, proj_memory=proj_memories)
            contexts.append(vle["output"])
            weights.append(vle["weights"])
            c_c = cell.fetch(params["higher"], vle["output"], ln)
        h = carry(s, cell.step(params["higher"], s, c_c, ln), keep[t])
        outs.append(h)

    outputs = torch.stack(outs, dim=1)
    if one2one:
        contexts = memory
        onehot = (torch.arange(src_len, device=x.device)[None, :]
                  == torch.arange(length, device=x.device)[:, None])
        weights = onehot.float()[None, None].expand(batch, num_heads, length,
                                                     src_len)
    else:
        contexts = torch.stack(contexts, dim=1)
        weights = torch.stack(weights, dim=2)
    return ((outputs, h), (cell.get_hidden(outputs), cell.get_hidden(h)),
            contexts, weights)


def cond_rnn_step(cell_name: str, params, h_, x_t, memory, mem_mask,
                  proj_memories, ln=False, num_heads: int = 1):
    """One decode step of cond_rnn in attention mode: x_t [B(*K), d_in]
    against the untiled memory. Returns (new_state, hidden, context)."""
    cell = get_cell(cell_name)
    s = cell.step(params["lower"], h_, cell.fetch(params["lower"], x_t, ln),
                  ln)
    c = attn_mod.additive_attention(
        params["attention"], cell.get_hidden(s), memory, mem_mask,
        num_heads=num_heads, proj_memory=proj_memories)["output"]
    h = cell.step(params["higher"], s, cell.fetch(params["higher"], c, ln),
                  ln)
    return h, cell.get_hidden(h), c
