"""Device programs of the port: hashing lives in fingerprint.py; compaction,
the visited set, dedup, the ring and expansion live here."""
