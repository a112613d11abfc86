"""The port's span taxonomy beside the reference's.

The port's runtime records spans the reference has no counterpart of:
``admit``'s children ``canonicalize``, ``probe`` and ``route``, the
layer-cache ``seed`` probe and, before each ``dispatch``, the
``lane_wait`` from the hand-off to the lane until the lane begins.  A
tree compared with the reference's is compared without them; the tests
of ``tests/test_torch_obs.py`` pin the port's whole trees.
"""
PORT_SPANS = frozenset({"canonicalize", "probe", "route", "seed",
                        "lane_wait"})


def reference_shape(shape):
    """A ``Span.shape()`` with the port's own spans taken out."""
    name, children = shape
    return (name, tuple(reference_shape(c) for c in children
                        if c[0] not in PORT_SPANS))


def port_span_count(root) -> int:
    """How many of the port's own spans a tree holds."""
    return sum(1 for s in root.walk() if s.name in PORT_SPANS)
