"""Feature detection, description, matching and match filtering, ORB and
VITAMIN-E's curvature extrema (counterpart of
``tadataka_tpu/features``)."""

from tadataka_torch.features.detector import (
    detect_fast, detect_harris, Features)
from tadataka_torch.features.brief import brief_descriptors, extract_features
from tadataka_torch.features.matching import (
    match_descriptors, Matches, Matcher)
from tadataka_torch.features.orb import (
    corner_orientations, extract_orb_features, orb_descriptors)
from tadataka_torch.features.ransac import ransac_fundamental, ransac_affine
from tadataka_torch.features.filters import symmetric_transfer_filter
from tadataka_torch.features.curvature import (
    compute_image_curvature, extract_curvature_extrema)
from tadataka_torch.features.extrema_tracker import ExtremaTracker
