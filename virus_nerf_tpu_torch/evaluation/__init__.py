"""Evaluation: mapping NND metrics, PSNR/SSIM, scan rendering."""
