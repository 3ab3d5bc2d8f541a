"""Host-side IO, feature storage types and request padding."""
