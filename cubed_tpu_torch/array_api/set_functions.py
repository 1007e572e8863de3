"""Set functions, refused: every ``unique_*`` has an output shape that
depends on the data, which a lazy plan of static shapes cannot express.
Counterpart of ``cubed_tpu/array_api/set_functions.py``."""

_MSG = (
    "{name} has a data-dependent output shape, which a lazy, statically-"
    "shaped plan cannot express. Compute the array first and use numpy's "
    "unique on the result, or express the computation with sort/"
    "searchsorted/count_nonzero, whose shapes are static."
)


def unique_all(x, /):
    raise NotImplementedError(_MSG.format(name="unique_all"))


def unique_counts(x, /):
    raise NotImplementedError(_MSG.format(name="unique_counts"))


def unique_inverse(x, /):
    raise NotImplementedError(_MSG.format(name="unique_inverse"))


def unique_values(x, /):
    raise NotImplementedError(_MSG.format(name="unique_values"))
