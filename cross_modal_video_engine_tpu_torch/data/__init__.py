"""LINAS data provider: captions, frame features, batches on a device."""
