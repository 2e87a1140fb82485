"""Host-side weight codecs (numpy): I2_S flavor detection and QK256."""
