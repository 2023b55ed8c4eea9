"""Class-definition ("concept") word lists of the text-embedding assets
(counterpart of ``semivl_tpu/text/concepts.py``; reference
model/text_embeddings.py:24-153). A class may be described by several
concepts; dense predictions over concepts are max-aggregated back to
classes (``text.embeddings.aggregate_concept_predictions``). The lists
carried here are those of the guidance labels of the two ported models:
VOC ``concept4`` (exp 40) and Cityscapes ``concept3`` (exp 44).
"""

CITYSCAPES_CLASSES_W_CONCEPTS3 = [
    ['road', 'street', 'parking space'],
    ['sidewalk'],
    ['building', 'skyscaper', 'house', 'bus stop building', 'garage',
     'car port', 'scaffolding'],
    ['individual standing wall, which is not part of a building'],
    ['fence', 'hole in fence'],
    ['pole', 'sign pole', 'traffic light pole'],
    ['traffic light'],
    ['traffic sign', 'parking sign', 'direction sign'],
    ['vegetation', 'tree', 'hedge'],
    ['terrain', 'grass', 'soil', 'sand'],
    ['sky'],
    ['person', 'pedestrian', 'walking person', 'standing person',
     'person sitting on the ground', 'person sitting on a bench',
     'person sitting on a chair'],
    ['rider', 'cyclist', 'motorcyclist'],
    ['car', 'jeep', 'SUV', 'van'],
    ['truck', 'box truck', 'pickup truck', 'truck trailer'],
    ['bus'],
    ['train', 'tram'],
    ['motorcycle', 'moped', 'scooter'],
    ['bicycle'],
]

VOC12_WBG_CLASSES_W_CONCEPTS4 = [
    ['background', 'bed', 'building', 'cabinet', 'ceiling', 'curtain', 'door',
     'fence', 'floor', 'grass', 'ground', 'mountain', 'road', 'rock',
     'shelves', 'sidewalk', 'sky', 'snow', 'tree', 'wall', 'water', 'window',
     'hang glider', 'helicopter', 'jet ski', 'go-cart', 'tractor',
     'emergency vehicle', 'lorry', 'truck', 'lion', 'stool', 'bench',
     'wheelchair', 'coffee table', 'desk', 'side table', 'picnic bench',
     'wolve', 'flowers in a vase', 'goat', 'tram', 'laptop',
     'advertising display', 'vehicle interior'],
    ['aeroplane', 'airplane', 'glider'],
    ['bicycle', 'tricycle', 'unicycle'],
    ['bird'],
    ['boat', 'ship', 'rowing boat', 'pedalo'],
    ['bottle', 'plastic bottle', 'glass bottle', 'feeding bottle'],
    ['bus', 'minibus'],
    ['car', 'van', 'large family car', 'realistic toy car'],
    ['cat', 'domestic cat'],
    ['chair', 'armchair', 'deckchair'],
    ['cow'],
    ['dining table', 'table for eating at'],
    ['dog', 'domestic dog'],
    ['horse', 'pony', 'donkey', 'mule'],
    ['motorbike', 'moped', 'scooter', 'sidecar'],
    ['person', 'people', 'baby', 'face'],
    ['potted plant', 'indoor plant in a pot', 'outdoor plant in a pot'],
    ['sheep'],
    ['sofa'],
    ['train', 'train carriage'],
    ['tv', 'monitor', 'standalone screen'],
]


def flatten_class_concepts(class_concepts):
    """``(concepts, concept_to_class_idx, class_to_concept_idxs)`` of a
    per-class concept list (reference model/text_embeddings.py:195-206)."""
    concepts = []
    concept_to_class_idx = {}
    class_to_concept_idxs = {}
    for cls_i, cls_concepts in enumerate(class_concepts):
        for concept in cls_concepts:
            concept_to_class_idx[len(concepts)] = cls_i
            class_to_concept_idxs.setdefault(cls_i, []).append(len(concepts))
            concepts.append(concept)
    return concepts, concept_to_class_idx, class_to_concept_idxs


# Embedding asset name -> concept list, for concept (non-averaged) variants.
CONCEPT_LISTS = {
    'voc12_wbg_concept4_single': VOC12_WBG_CLASSES_W_CONCEPTS4,
    'cityscapes_concept3_single': CITYSCAPES_CLASSES_W_CONCEPTS3,
}
