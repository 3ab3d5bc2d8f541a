"""Device selection and the weight bridge from vlsa_tpu parameter trees."""
