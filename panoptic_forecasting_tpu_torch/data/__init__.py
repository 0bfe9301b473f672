"""The port's data layer: Cityscapes pc inputs, fg scenes, the bg serving
card, the loader, artifact IO with a PNG codec of its own, and synthetic
fixtures."""

from .cards import DataCard
