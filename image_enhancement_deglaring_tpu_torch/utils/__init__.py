"""Seeding, flat-npz trees and the experiment logger."""

from .explog import ExperimentLogger
from .pytree import flatten_tree, load_npz_tree, unflatten_tree
from .seeding import set_seed
