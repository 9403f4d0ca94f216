"""Host-side result encoding (mask paste and COCO RLE)."""
