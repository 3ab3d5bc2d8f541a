"""The engines and the serving, training and extraction command lines."""
