"""Waksman permutation-network control bits (a port of ``repro.core.waksman``).

MP-SPDZ implements its secure shuffle as a Waksman network whose control
bits encode the secret permutation; the engine's shuffle is the 3-hop
permutation composition (``core/shuffle.py``), and this routing serves
cross-checks against the MP-SPDZ cost model. A network on n = 2^m inputs
has n log2(n) - n + 1 switches; evaluated obliviously, each costs one select
(one AND word).

``route(perm)`` computes the layered switch settings: plaintext host logic
over a numpy permutation, as in the reference. ``apply_network(bits, xs)``
evaluates the network on a tensor's rows (the plaintext oracle; the
oblivious evaluation would replace each switch with the share-level
``select``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["route", "apply_network", "n_switches"]


def n_switches(n: int) -> int:
    """Switches of the network on ``n`` (a power of two) inputs."""
    if n <= 1:
        return 0
    if n == 2:
        return 1
    return (n - 1) + 2 * n_switches(n // 2)  # n/2 - 1 + n/2 outer, two subnets


def route(perm) -> List:
    """Switch settings of an AS-Waksman network for ``perm``, which maps
    output position -> input position (out[i] = in[perm[i]]).

    Returns ``(in_bits, (sub_top, sub_bottom), out_bits)`` for n > 2, one
    bool for n == 2 and None for n == 1. Power-of-two sizes only.
    """
    perm = np.asarray(perm)
    n = len(perm)
    if n < 1 or n & (n - 1):
        raise ValueError(f"route takes power-of-two sizes, got {n}")
    if n == 1:
        return None
    if n == 2:
        return bool(perm[0] == 1)
    half = n // 2

    in_bits = [False] * half  # input switch i handles inputs (2i, 2i+1)
    out_bits = [False] * half  # output switch i handles outputs (2i, 2i+1)
    top = [-1] * half  # the two sub-permutations being built
    bot = [-1] * half
    out_done = [False] * half
    # output switch i unset (False) sends top -> output 2i; the last output
    # switch is fixed straight (Waksman)
    inv = np.empty(n, dtype=int)
    inv[perm] = np.arange(n)

    def set_path_from_output(out_pos: int, use_top: bool) -> None:
        """Route output ``out_pos`` through the given subnet and follow the
        constraints it implies around the cycle."""
        while True:
            osw, olane = divmod(out_pos, 2)
            # output switch: False sends top -> lane 0, bottom -> lane 1
            out_bits[osw] = bool((use_top and olane == 1) or (not use_top and olane == 0))
            out_done[osw] = True
            subnet = top if use_top else bot
            isw, ilane = divmod(int(perm[out_pos]), 2)
            # input switch: False sends lane 0 -> top, lane 1 -> bottom
            in_bits[isw] = bool((use_top and ilane == 1) or (not use_top and ilane == 0))
            subnet[osw] = isw
            # the sibling input lane goes to the other subnet
            sib_out = int(inv[isw * 2 + (1 - ilane)])
            other = bot if use_top else top
            ssw = sib_out // 2
            other[ssw] = isw
            s_bit = ((not use_top) and sib_out % 2 == 1) or (use_top and sib_out % 2 == 0)
            if out_done[ssw]:
                break
            out_bits[ssw] = bool(s_bit)
            out_done[ssw] = True
            # go on from the sibling output's partner lane
            out_pos = ssw * 2 + (1 - sib_out % 2)
            use_top = (out_pos % 2 == 0) == (not out_bits[ssw])
            if out_done[out_pos // 2] and top[out_pos // 2] >= 0 and bot[out_pos // 2] >= 0:
                break

    for start in range(half - 1, -1, -1):
        if top[start] >= 0 and bot[start] >= 0:
            continue
        set_path_from_output(2 * start, not out_bits[start])
        if bot[start] < 0 or top[start] < 0:
            set_path_from_output(2 * start + 1, out_bits[start])

    return (in_bits, (route(np.array(top)), route(np.array(bot))), out_bits)


def apply_network(bits, xs: torch.Tensor) -> torch.Tensor:
    """Plaintext evaluation (oracle): the rows of ``xs`` (axis 0) permuted
    as the routing ``bits`` says."""
    n = xs.shape[0]
    if n == 1:
        return xs.clone()
    if n == 2:
        return xs.flip(0) if bits else xs.clone()
    in_bits, (sub_t, sub_b), out_bits = bits
    half = n // 2
    pairs = xs.reshape((half, 2) + tuple(xs.shape[1:]))
    swap_in = torch.tensor(in_bits, device=xs.device)
    swap_in = swap_in.reshape((half,) + (1,) * (xs.dim() - 1))
    top_in = torch.where(swap_in, pairs[:, 1], pairs[:, 0])
    bot_in = torch.where(swap_in, pairs[:, 0], pairs[:, 1])
    top_out = apply_network(sub_t, top_in)
    bot_out = apply_network(sub_b, bot_in)
    swap_out = torch.tensor(out_bits, device=xs.device).reshape(swap_in.shape)
    first = torch.where(swap_out, bot_out, top_out)
    second = torch.where(swap_out, top_out, bot_out)
    return torch.stack([first, second], dim=1).reshape(xs.shape)
