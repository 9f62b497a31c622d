"""Audio input of the port: decoding, the db, augmentation, units."""
