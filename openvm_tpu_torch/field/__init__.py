"""Field arithmetic: the BabyBear base field and its quartic extension."""

from . import babybear, ext  # noqa: F401
