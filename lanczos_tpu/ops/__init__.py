from . import operators, hermitian_split, filters
