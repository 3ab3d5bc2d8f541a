"""Host-side IO, feature storage types and request padding; tile
preprocessing and feature extraction."""
