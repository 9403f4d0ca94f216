"""Host-side result encoding (mask paste and COCO RLE) and point AP."""
