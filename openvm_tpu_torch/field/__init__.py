"""Field arithmetic: the BabyBear base field."""

from . import babybear  # noqa: F401
