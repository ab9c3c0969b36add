"""Operations of the ITC streams' steps, from the shapes of what ran, counted
as the algorithm needs them (``lib/bounds.py``'s rules and constants: a
faster program lowers the time, never the count). ``d`` is the embedding
width; the backward pass takes ``BACKWARD`` times the forward's FLOPs, the
Adagrad update ``ADAGRAD`` FLOPs per element of each unique row it
touches. Activations (tanh, softplus) count one operation an element.

The relation view's step is ``bounds.chunk_step_flops``. The others:

  * positives-only TransE (``ckge_rel``, ``ckgp_rel``): a row's distance
    (``TRANSE``) and the normalization of its three gathered rows
    (``NORM`` each), per ``d``; the softplus and the weight, two an row;
  * the CNN scorer (``attr_view``, ``ckge_attr``, ``ckga_attr``), a row:
    the head's normalization; batch norm, two operations an element of
    the (2, d) image; each (kh, kw) convolution, a multiply and an add an
    input of its window, a bias and a tanh an output; the l2 normalization
    over the width, three an element; the dense layer, a multiply and an
    add a weight, a bias and a tanh an output; the whole-tensor
    normalization, three an output; the score, three an element; the
    softplus, the weight and the mask, three a row. The scorer's own
    parameters are updated whole, ``ADAGRAD`` FLOPs each;
  * ``common_space``, an entity: three normalizations and three squared
    distances of ``d`` (three operations an element each).
"""
from __future__ import annotations

from gpubench.lib.bounds import ADAGRAD, BACKWARD, NORM, TRANSE

IMAGE_ROWS = 2          # the (attribute, value) image's rows


def conv_params(d: int, kernel=(2, 4), maps: int = 2, layers: int = 2) -> int:
    """The parameters of one CNN scorer."""
    kh, kw = kernel
    n, cin = 2 * d, 1                              # batch norm gamma, beta
    for _ in range(layers):
        n += kh * kw * cin * maps + maps
        cin = maps
    return n + IMAGE_ROWS * d * maps * d + d


def conv_row_flops(d: int, kernel=(2, 4), maps: int = 2,
                   layers: int = 2) -> int:
    """The CNN scorer's forward FLOPs for one (h, a, v) row, with the
    head's normalization and the row's loss term."""
    kh, kw = kernel
    image = IMAGE_ROWS * d
    flops = NORM * d + 2 * image
    cin = 1
    for _ in range(layers):
        flops += image * maps * (2 * kh * kw * cin + 2)
        cin = maps
    flops += 3 * image * maps                       # l2 over the width
    flops += d * (2 * image * maps + 2)             # dense, bias, tanh
    return flops + 3 * d + 3 * d + 3                # norm, score, loss


def conv_step_flops(d: int, rows: int, unique_rows: int) -> int:
    """One CNN-scored step of ``rows`` rows; ``unique_rows`` the distinct
    entity and attribute rows it updates."""
    return (rows * conv_row_flops(d) * (1 + BACKWARD)
            + ADAGRAD * (d * unique_rows + conv_params(d)))


def transe_pos_step_flops(d: int, rows: int, unique_rows: int) -> int:
    """One positives-only TransE step of ``rows`` triples."""
    fwd = rows * (d * (TRANSE + 3 * NORM) + 2)
    return fwd * (1 + BACKWARD) + ADAGRAD * d * unique_rows


def common_space_step_flops(d: int, rows: int, unique_rows: int) -> int:
    """One common-space step of ``rows`` entities; ``unique_rows`` the
    distinct rows of the three tables it updates, together."""
    fwd = rows * d * (3 * NORM + 3 * 3)
    return fwd * (1 + BACKWARD) + ADAGRAD * d * unique_rows
