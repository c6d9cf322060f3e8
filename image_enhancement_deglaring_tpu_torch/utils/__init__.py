"""Seeding, flat-npz trees, the experiment logger and the .env loader."""

from .envfile import load_dotenv
from .explog import ExperimentLogger
from .pytree import flatten_tree, load_npz_tree, unflatten_tree
from .seeding import set_seed
