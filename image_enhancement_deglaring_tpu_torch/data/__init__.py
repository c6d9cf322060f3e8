"""The port's data pipeline: PNG codec, SD1 decode, augmentation, loaders."""

from .augment import heavy_augment, optimized_augment
from .dataset import DevicePrefetcher, GlareRemovalDataset, make_dataloaders
from .pipeline import decode_inference_image, decode_triptych, list_image_paths, seeded_split
from .png import decode_png, encode_png, read_png, write_png
from .synthetic import generate_synthetic_sd1, make_triptych
