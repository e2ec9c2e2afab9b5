"""Host-side (numpy) client-selection core, mirroring ``repro.core``."""
