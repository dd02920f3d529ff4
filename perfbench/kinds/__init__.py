"""One driver a traffic kind, found by the mix's ``kind``."""
